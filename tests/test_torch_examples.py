"""The port's examples (examples/*_torch.py) against the originals, on the
CPU (``device="cpu"``).

- The KV store (S10 application #1): `DURATION` cut to 0.05 s on both
  modules; the unreplicated and the Nezha summaries are equal.
- The fair-access exchange (S10 application #2): the original's `main()`
  and the port's at the default duration print the same lines.
- The quickstart, demo by demo: consensus and scenarios print the same
  lines; the protocol zoo over the names both registries have; the
  training demo from the reference's initial state carried across
  (`train_state_from_reference`, both packages computing in float32):
  losses within 1e-4 and the metadata log's fast-commit ratio equal, each
  run's checkpoints in its own temporary directory; the kernel demo
  against the reference's dense oracle within its float32 tolerance 2e-5.
- Replicated serving from the reference's parameters
  (`params_from_reference`, float32): the same lines, tokens and
  fingerprints included.
"""
import contextlib
import io
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core
import repro.models.layers as jl
import repro.models.model as jm
import repro.models.transformer as jtf
import repro_torch.models.layers as tl
import repro_torch.models.model as tm
import repro_torch.train.train_step as tts

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))

import fair_exchange  # noqa: E402
import fair_exchange_torch  # noqa: E402
import quickstart  # noqa: E402
import quickstart_torch  # noqa: E402
import replicated_kv_store  # noqa: E402
import replicated_kv_store_torch  # noqa: E402
import replicated_serving  # noqa: E402
import replicated_serving_torch  # noqa: E402

CPU = "cpu"


def _printed(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        value = fn(*args, **kw)
    return out.getvalue().splitlines(), value


@pytest.fixture
def f32_compute(monkeypatch):
    for mod in (jl, jm, jtf):
        monkeypatch.setattr(mod, "CDT", jnp.float32)
    for mod in (tl, tm):
        monkeypatch.setattr(mod, "CDT", torch.float32)


def _same_summary(a: dict, b: dict):
    assert list(a) == list(b)
    for key in a:
        x, y = a[key], b[key]
        assert x == y or (isinstance(x, float) and np.isnan(x)
                          and np.isnan(y)), key


def test_kv_store_summaries_are_the_originals(monkeypatch):
    monkeypatch.setattr(replicated_kv_store, "DURATION", 0.05)
    monkeypatch.setattr(replicated_kv_store_torch, "DURATION", 0.05)
    lines, (u, n) = _printed(replicated_kv_store_torch.main, CPU)
    _same_summary(u, replicated_kv_store.run_unreplicated())
    _same_summary(n, replicated_kv_store.run_nezha())
    assert n["committed"] > 0 and len(lines) == 3
    assert lines[2].startswith("replication cost: ")


def test_fair_exchange_prints_the_originals_lines():
    want, _ = _printed(fair_exchange.main)
    got, _ = _printed(fair_exchange_torch.main, device=CPU)
    assert got == want
    assert got[-1].startswith("deterministic replay: OK")


def test_quickstart_consensus_is_the_originals():
    want, _ = _printed(quickstart.demo_consensus)
    got, _ = _printed(quickstart_torch.demo_consensus)
    assert got == want


def test_quickstart_protocol_zoo_is_the_originals(monkeypatch):
    """The names both registries have (the reference's two tier-pinned
    names have no port). The reference's `nezha-sharded` defaults to its
    jit tier, which imports `jax.experimental.enable_x64`: this jax spells
    it `jax.enable_x64`, so the test lends it that name."""
    import jax.experimental

    from repro_torch.core import available_clusters

    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)

    names = [n for n in repro.core.available_clusters()
             if n in available_clusters()]
    assert len(names) == len(available_clusters()) == 12
    monkeypatch.setattr(repro.core, "available_clusters", lambda: names)
    want, _ = _printed(quickstart.demo_protocol_zoo)
    got, _ = _printed(quickstart_torch.demo_protocol_zoo, CPU)
    assert got == want and len(got) == 13


def test_quickstart_scenarios_are_the_originals():
    want, _ = _printed(quickstart.demo_scenarios)
    got, _ = _printed(quickstart_torch.demo_scenarios, CPU)
    assert got == want


def test_quickstart_training_from_the_references_state(monkeypatch, tmp_path,
                                                       f32_compute):
    from repro.launch.train import Trainer as JTrainer
    from repro.launch.train import TrainerConfig as JTrainerConfig

    ref = JTrainer(JTrainerConfig(arch="tinyllama-1.1b", smoke=True, steps=8,
                                  batch=4, seq=64,
                                  ckpt_dir=str(tmp_path / "ref"),
                                  ckpt_every=4))
    carried = tm.train_state_from_reference(
        jax.tree.map(np.asarray, ref.state), device=CPU)
    monkeypatch.setattr(tts, "make_train_state",
                        lambda cfg, seed=None, device=None: carried)
    _, want = _printed(ref.run)
    lines, got = _printed(quickstart_torch.demo_training, CPU,
                          ckpt_dir=str(tmp_path / "port"))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= 1e-4
    assert lines[-1] == (f"   metadata-log fast-commit ratio: "
                         f"{ref.log.fast_commit_ratio:.0%}")
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "ref").iterdir())


def test_quickstart_kernel_demo_is_within_the_oracles_tolerance():
    from repro.kernels.ref import flash_attention_ref

    lines, err = _printed(quickstart_torch.demo_kernel, CPU)
    assert err <= 2e-5 and lines[-1].startswith("   max |kernel - oracle|")
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(0, 0.5, shape) for shape in (
        (1, 128, 4, 32), (1, 128, 2, 32), (1, 128, 2, 32)))
    want = flash_attention_ref(*(jnp.asarray(x, jnp.float32)
                                 for x in (q, k, v)))
    from repro_torch.kernels.flash_attention import flash_attention

    got = flash_attention(*(torch.as_tensor(x, dtype=torch.float32)
                            for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def test_replicated_serving_prints_the_originals_lines(monkeypatch,
                                                       f32_compute):
    cfg = replicated_serving.smoke_config("tinyllama-1.1b")
    pj = jm.init_params(cfg, jax.random.PRNGKey(0))
    monkeypatch.setattr(
        replicated_serving_torch, "init_params",
        lambda cfg, seed, device: tm.params_from_reference(
            jax.tree.map(np.asarray, pj), device=device))
    want, _ = _printed(replicated_serving.main)
    got, outputs = _printed(replicated_serving_torch.main, CPU)
    assert got == want
    assert len(outputs) == 3 and all(len(o) == 6 for o in outputs.values())
