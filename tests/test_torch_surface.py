"""The port's package surface against the reference's: for every module
or package of `repro` that has a counterpart in `repro_torch` (the same
relative path), each name in the reference's ``__all__`` exists in the
port -- as an attribute or as a submodule.

Exempt: the compute tiers (``TIERS``, ``make_tier``, ``*Tier``: the port's
"tiers" are devices), the ``*_pallas`` / ``*_jnp`` / ``*_traced`` names
(JAX forms whose torch counterparts carry other names), the names the
port replaced by design (``REPLACED``, each with its reason), and the
names of the modules ROADMAP.md still queues, each under its label there
(B9: `parallel/` and the launch tools)."""
import ast
import importlib
import importlib.util
import re
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
EXEMPT_RE = re.compile(r"^(TIERS|make_tier)$|Tier$|_(pallas|jnp|traced)$")
REPLACED = {
    # the TPU's two-int32-word time keys: Hopper compares 64-bit words, so
    # the port's kernels take one int64 key (`time_sort_keys`, KEY_INF)
    "repro.kernels.timekeys": (
        "one-word keys", {"lex_gt", "I32_MIN", "I32_MAX", "HI_INF",
                          "LO_INF"}),
    # exported but called nowhere in the reference (its transformer only
    # imports it); the port's `init_params` sets every norm leaf by name
    "repro.models.layers": ("unused by the reference", {"norm_params"}),
    # the reference's staged numpy pipeline, a seam of `repro`
    # (`DomEngine(stages=...)`): the port's engine runs FUSED_STAGES, whose
    # body on the CPU is held bit for bit against that pipeline
    "repro.core.engine": ("the fused stages", {
        "StampStage", "DomStage", "CommitStage", "DEFAULT_STAGES"}),
}
QUEUED = {
    # ROADMAP B9: the sharding rules and the other collectives
    "repro.parallel": ("B9", {
        "batch_spec", "cache_shardings", "param_shardings", "DATA_AXES",
        "MODEL_AXIS"}),
    "repro.parallel.collectives": ("B9", {
        "deadline_masked_mean", "StragglerState", "straggler_init",
        "apply_straggler_feedback", "compressed_allreduce",
        "CompressionState", "compression_init", "compress_with_feedback"}),
}


def _module_name(path: Path) -> str:
    rel = path.relative_to(SRC).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


def _declared_all(path: Path):
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return list(ast.literal_eval(node.value))
    return None


def _paired_modules() -> list:
    pairs = []
    for path in sorted((SRC / "repro").rglob("*.py")):
        port = SRC / "repro_torch" / path.relative_to(SRC / "repro")
        names = _declared_all(path)
        if names is not None and port.exists():
            pairs.append((_module_name(path), names))
    return pairs


PAIRS = _paired_modules()


def _has(module, port_name: str, name: str) -> bool:
    """``name`` is an attribute of the port's module, or a submodule of
    the port's package."""
    return hasattr(module, name) or (
        hasattr(module, "__path__") and importlib.util.find_spec(
            f"{port_name}.{name}") is not None)


def test_the_surface_has_modules_to_check():
    names = {name for name, _ in PAIRS}
    assert {"repro.models", "repro.serving", "repro.core", "repro.sim",
            "repro.train", "repro.ckpt", "repro.data",
            "repro.parallel.collectives", "repro.core.sharded",
            "repro.sim.workload"} <= names


@pytest.mark.parametrize("name,names", PAIRS, ids=[n for n, _ in PAIRS])
def test_port_exports_the_references_names(name, names):
    port_name = "repro_torch" + name[len("repro"):]
    port = importlib.import_module(port_name)
    exempt = QUEUED.get(name, ("", set()))[1] | REPLACED.get(
        name, ("", set()))[1]
    missing = [n for n in names if not EXEMPT_RE.search(n)
               and n not in exempt and not _has(port, port_name, n)]
    assert not missing, f"{port_name} lacks {missing}"


@pytest.mark.parametrize("name", sorted(QUEUED))
def test_queued_names_are_the_references_and_still_missing(name):
    """Each queued name is in the reference's ``__all__`` and not yet in
    the port: when a slice ports one, it leaves this list."""
    label, queued = QUEUED[name]
    assert label == "B9"
    names = dict(PAIRS)[name]
    assert queued <= set(names)
    port_name = "repro_torch" + name[len("repro"):]
    port = importlib.import_module(port_name)
    assert not [n for n in queued if _has(port, port_name, n)]


@pytest.mark.parametrize("name", sorted(REPLACED))
def test_replaced_names_are_the_references_and_not_copied(name):
    """Each replaced name is in the reference's ``__all__`` and not in the
    port: it is not kept beside what replaced it."""
    _, replaced = REPLACED[name]
    assert replaced <= set(dict(PAIRS)[name])
    port_name = "repro_torch" + name[len("repro"):]
    port = importlib.import_module(port_name)
    assert not [n for n in replaced if _has(port, port_name, n)]


def test_workload_records_and_summaries_are_the_references():
    """The ported `sim/workload.py` pieces give the reference's results."""
    import numpy as np

    from repro.sim import workload as jw
    from repro_torch.sim import workload as tw

    out = []
    for mod in (jw, tw):
        recs = [mod.RequestRecord(0, i, 0.1 * i, 0.1 * i + 1e-3 * (i + 1),
                                  fast_path=i % 2 == 0) for i in range(7)]
        recs.append(mod.RequestRecord(1, 9, 1.0))
        out.append(mod.summarize_latencies(recs))
    assert out[0] == out[1] and out[0]["committed"] == 7
    a_t = tw.OpenLoopWorkload(3, 100.0, seed=4).arrival_array(0.2)
    a_j = jw.OpenLoopWorkload(3, 100.0, seed=4).arrival_array(0.2)
    for x, y in zip(a_t, a_j):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
    sent = []
    closed = tw.ClosedLoopWorkload(2, sent.append)
    closed.start()
    closed.on_commit(1, lambda dt, fn: fn())
    assert sent == [0, 1, 1]


@pytest.fixture
def reference_x64(monkeypatch):
    """The reference's DOM oracles import `jax.experimental.enable_x64`,
    which this jax spells `jax.enable_x64`: lend them that name."""
    import jax
    import jax.experimental

    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


@pytest.mark.parametrize("seed,now", [(2, 0.6), (5, 0.3), (9, 1.5)])
def test_dom_release_oracles_are_the_references(reference_x64, seed, now):
    """`ref.dom_release_ref` and `ops.dom_release_ref_order` give the
    reference's results, bit for bit, on float64 times with ties."""
    import numpy as np
    import torch

    import repro.kernels.ops as jops
    import repro.kernels.ref as jref
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.dom_admit import dom_admit_plain

    rng = np.random.default_rng(seed)
    d = np.round(rng.random(64), 3)                   # ties among deadlines
    a = d - rng.random(64) * 0.3
    released, ranks = ref.dom_release_ref(torch.as_tensor(d),
                                          torch.as_tensor(a), now)
    j_released, j_ranks = jref.dom_release_ref(d, a, now)
    assert np.array_equal(released.numpy(), np.asarray(j_released))
    assert np.array_equal(ranks.numpy(), np.asarray(j_ranks))
    admitted = dom_admit_plain(torch.as_tensor(d),
                               torch.as_tensor(a)[:, None])[:, 0]
    order, count = ops.dom_release_ref_order(d, admitted.numpy(), now)
    j_order, j_count = jops.dom_release_ref_order(d, admitted.numpy(), now)
    assert int(count) == int(j_count) == int(released.sum())
    assert np.array_equal(np.asarray(order, dtype=np.int64),
                          np.asarray(j_order, dtype=np.int64))


def test_dom_release_oracles_agree_with_the_plain_release():
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.dom_admit import dom_admit_plain

    gen = torch.Generator().manual_seed(2)
    d = torch.rand(50, generator=gen, dtype=torch.float64)
    a = d - torch.rand(50, generator=gen, dtype=torch.float64) * 0.3
    released, ranks = ref.dom_release_ref(d, a, 0.6)
    admitted = dom_admit_plain(d, a[:, None])[:, 0]
    order, count = ops.dom_release_ref_order(d, admitted, 0.6)
    assert int(count) == int(released.sum())
    assert bool((ranks[order[:int(count)].long()] ==
                 torch.arange(int(count), dtype=torch.int32)).all())
    assert bool((ranks[~released] == -1).all())
