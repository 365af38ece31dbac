"""The port's LM slice (repro_torch configs, layers, model, serving) against
the reference's, at `smoke_config("tinyllama-1.1b")` (dense family) and
`smoke_config("mamba2-130m")` (ssm family: N 16, P 16, chunk 16).

Both packages get the same parameters (the reference's `init_params`,
carried across with `params_from_reference`) and the same numpy-seeded
tokens. Tolerances:
- float32 compute (both packages' compute dtype set to float32 for the
  test): 1e-4 -- the same arithmetic, summed in another order;
- bf16 compute (the packages as they ship): 2^-5 of the largest magnitude
  of the compared tensor. bf16 keeps 8 significant bits, and the two
  frameworks round the residual stream and the products' outputs at the
  same points but sum in different orders, so a few units in the last
  place of the largest value build up over the layers (2^-5 is four units
  at the top of its binade).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jl
import repro.models.model as jm
import repro_torch.models.layers as tl
import repro_torch.models.model as tm
from repro.configs import all_arch_names as j_all_arch_names
from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.serving.engine import GenRequest as JGenRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs import all_arch_names, get_config, smoke_config
from repro_torch.models import transformer as ttf
from repro_torch.serving.engine import GenRequest, ServingEngine
from repro_torch.serving.kv_cache import SlotPool, write_prefill_into_cache

ARCH = "tinyllama-1.1b"
F32_TOL = 1e-4


def bf16_tol(ref) -> float:
    return float(np.abs(np.asarray(ref, np.float32)).max()) * 2 ** -5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module")
def setup():
    cfg_j, cfg_t = j_smoke_config(ARCH), smoke_config(ARCH)
    pj = jm.init_params(cfg_j, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, pj)
    pt = tm.params_from_reference(tree, device="cpu")
    return cfg_j, cfg_t, pj, tree, pt


@pytest.fixture
def f32_compute(monkeypatch):
    """Both packages compute in float32 (the algorithm, not the rounding)."""
    monkeypatch.setattr(jl, "CDT", jnp.float32)
    monkeypatch.setattr(jm, "CDT", jnp.float32)
    monkeypatch.setattr(tl, "CDT", torch.float32)
    monkeypatch.setattr(tm, "CDT", torch.float32)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape,
                                                dtype=np.int64).astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
def test_configs_are_the_references():
    assert all_arch_names() == j_all_arch_names()
    for name in all_arch_names():
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(j_get_config(name))
    assert dataclasses.asdict(smoke_config(ARCH, n_layers=3)) == \
        dataclasses.asdict(j_smoke_config(ARCH, n_layers=3))


ALL_CONFIGS = ["arctic-480b", "chatglm3-6b", "dbrx-132b", "granite-20b",
               "hymba-1.5b", "mamba2-130m", "phi-3-vision-4.2b", "qwen2-7b",
               "seamless-m4t-large-v2", "tinyllama-1.1b"]


def test_all_configs_lists_the_registry():
    assert all_arch_names() == ALL_CONFIGS


@pytest.mark.parametrize("name", ALL_CONFIGS)
def test_count_params_equals_the_references(name):
    assert tm.count_params(get_config(name)) == \
        jm.count_params(j_get_config(name))
    assert get_config(name).n_params() == j_get_config(name).n_params()
    assert get_config(name).n_active_params() == \
        j_get_config(name).n_active_params()


@pytest.mark.parametrize("name", ALL_CONFIGS)
def test_every_config_runs_prefill_and_a_decode_step(name):
    """Every registered config at smoke size: prefill and one decode step
    run on the CPU and give finite logits of the vocabulary's width (the
    families' numbers against the reference are in
    `tests/test_torch_families.py` and below)."""
    cfg = smoke_config(name)
    params = tm.init_params(cfg, seed=0, device="cpu")
    batch = {"tokens": torch.as_tensor(_tokens(cfg, (1, 9), seed=1))}
    if cfg.frontend:
        key = "src" if cfg.enc_dec else "frontend"
        batch[key] = torch.zeros(1, cfg.n_frontend_tokens, cfg.d_model)
    logits, _ = tm.make_prefill(cfg)(params, batch)
    cache = tm.zero_cache(cfg, 1, 8, device="cpu")
    step, _ = tm.make_decode_step(cfg)(params, cache, batch["tokens"][:, :1],
                                       0)
    for out in (logits, step):
        assert out.shape == (1, cfg.vocab) and bool(torch.isfinite(out).all())


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def test_params_from_reference_round_trips_every_leaf(setup):
    _, _, _, tree, pt = setup
    leaves_j = jax.tree_util.tree_leaves_with_path(tree)
    leaves_t = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), pt))
    assert [p for p, _ in leaves_j] == [p for p, _ in leaves_t]
    for (_, a), (_, b) in zip(leaves_j, leaves_t):
        assert b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_init_params_has_the_references_tree_and_distributions(setup):
    cfg_j, cfg_t, pj, _, _ = setup
    got = tm.init_params(cfg_t, seed=0, device="cpu")
    shapes_j = jax.tree.map(lambda a: tuple(a.shape), pj)
    shapes_t = jax.tree.map(lambda t: tuple(t.shape), got)
    assert shapes_j == shapes_t
    assert torch.equal(got["final_norm"]["scale"],
                       torch.ones(cfg_t.d_model))
    w = got["layers"]["mlp"]["w_up"]          # [L, d, f]: fan_in d
    assert abs(float(w.std()) * cfg_t.d_model ** 0.5 - 1.0) < 0.05
    again = tm.init_params(cfg_t, seed=0, device="cpu")
    assert torch.equal(again["embed"], got["embed"])
    assert not torch.equal(tm.init_params(cfg_t, seed=1,
                                          device="cpu")["embed"],
                           got["embed"])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def _x(shape, seed, dtype="bfloat16"):
    a = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.as_tensor(a).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_the_references(dtype):
    tol = {"float32": F32_TOL, "bfloat16": None}[dtype]

    def close(got, want):
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=tol or bf16_tol(_np(want)))

    xj, xt = _x((2, 7, 64), 1, dtype)
    sj, st = _x((64,), 2, "float32")
    bj, bt = _x((64,), 3, "float32")
    close(tl.rms_norm(xt, st), jl.rms_norm(xj, sj))
    close(tl.layer_norm(xt, st, bt), jl.layer_norm(xj, sj, bj))
    hj, ht = _x((2, 7, 4, 16), 4, dtype)
    pos = np.arange(7)[None, :] + 100
    for frac in (1.0, 0.5):
        close(tl.apply_rope(ht, torch.as_tensor(pos), frac, 10000.0),
              jl.apply_rope(hj, jnp.asarray(pos), frac, 10000.0))
    inv_j, rot_j = jl.rope_freqs(16, 1.0, 10000.0)
    inv_t, rot_t = tl.rope_freqs(16, 1.0, 10000.0)
    assert rot_j == rot_t
    np.testing.assert_array_equal(np.asarray(inv_j), inv_t.numpy())
    mlp = {k: _x(s, i + 10, "float32") for i, (k, s) in enumerate(
        {"w_gate": (64, 96), "w_up": (64, 96), "w_down": (96, 64),
         "b_up": (96,), "b_down": (64,)}.items())}
    pj = {k: v[0] / 8 for k, v in mlp.items()}
    pt = {k: v[1] / 8 for k, v in mlp.items()}
    close(tl.swiglu(xt, pt), jl.swiglu(xj, pj))
    close(tl.gelu_mlp(xt, pt), jl.gelu_mlp(xj, pj))
    table_j, table_t = _x((50, 64), 5, "float32")
    toks = np.random.default_rng(6).integers(0, 50, (2, 7))
    ej = jl.embed(jnp.asarray(toks), table_j)
    et = tl.embed(torch.as_tensor(toks), table_t)
    assert et.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(et), _np(ej))
    close(tl.unembed(xt, table_t), jl.unembed(xj, table_j))


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------
def _prefill_both(setup, tokens):
    cfg_j, cfg_t, pj, _, pt = setup
    lj, hj = jm.make_prefill(cfg_j)(pj, {"tokens": jnp.asarray(tokens)})
    lt, ht = tm.make_prefill(cfg_t)(pt, {"tokens": torch.as_tensor(tokens)})
    return (lj, hj), (lt, ht)


def test_prefill_matches_the_reference_in_bf16(setup):
    tokens = _tokens(setup[0], (2, 40), seed=0)
    (lj, hj), (lt, ht) = _prefill_both(setup, tokens)
    assert lt.dtype == torch.bfloat16 and lt.shape == (2, setup[0].vocab)
    assert ht.shape == (2, 40, setup[0].d_model)
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=0, atol=bf16_tol(lj))
    np.testing.assert_allclose(_np(ht), _np(hj), rtol=0, atol=bf16_tol(hj))


def test_prefill_matches_the_reference_in_f32(setup, f32_compute):
    tokens = _tokens(setup[0], (2, 33), seed=1)
    (lj, hj), (lt, ht) = _prefill_both(setup, tokens)
    assert lt.dtype == torch.float32
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(_np(ht), _np(hj), rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_decode_step_matches_the_reference(setup, compute, monkeypatch):
    if compute == "float32":
        for mod, val in ((jl, jnp.float32), (jm, jnp.float32),
                         (tl, torch.float32), (tm, torch.float32)):
            monkeypatch.setattr(mod, "CDT", val)
    cfg_j, cfg_t, pj, _, pt = setup
    B, Smax, steps = 3, 24, 6
    tokens = _tokens(cfg_j, (B, steps), seed=2)
    cj = jm.zero_cache(cfg_j, B, Smax)
    ct = tm.zero_cache(cfg_t, B, Smax, device="cpu")
    assert ct["kv"][0].shape == cj["kv"][0].shape
    assert str(ct["kv"][0].dtype).split(".")[-1] == str(cj["kv"][0].dtype)
    step_j = jax.jit(jm.make_decode_step(cfg_j))
    step_t = tm.make_decode_step(cfg_t)
    for i in range(steps):
        lj, cj = step_j(pj, cj, jnp.asarray(tokens[:, i:i + 1]), jnp.int32(i))
        lt, ct = step_t(pt, ct, torch.as_tensor(tokens[:, i:i + 1]), i)
        tol = F32_TOL if compute == "float32" else bf16_tol(lj)
        np.testing.assert_allclose(_np(lt), _np(lj), rtol=0, atol=tol)
    for a, b in zip(cj["kv"], ct["kv"]):
        tol = F32_TOL if compute == "float32" else bf16_tol(a)
        np.testing.assert_allclose(_np(b), _np(a), rtol=0, atol=tol)
        assert not np.any(_np(b)[:, :, steps:])          # untouched tail


@pytest.mark.parametrize("name", ["qwen2-7b", "granite-20b", "chatglm3-6b"])
def test_other_dense_configs_match_the_reference_in_f32(name, f32_compute):
    """The dense family's other switches: qkv biases (qwen2), layer norm,
    gelu MLP and learned positions (granite), half-rotary RoPE (chatglm3)."""
    cfg_j, cfg_t = j_smoke_config(name), smoke_config(name)
    pj = jm.init_params(cfg_j, jax.random.PRNGKey(1))
    pt = tm.params_from_reference(jax.tree.map(np.asarray, pj), device="cpu")
    tokens = _tokens(cfg_j, (2, 19), seed=5)
    lj, hj = jm.make_prefill(cfg_j)(pj, {"tokens": jnp.asarray(tokens)})
    lt, ht = tm.make_prefill(cfg_t)(pt, {"tokens": torch.as_tensor(tokens)})
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(_np(ht), _np(hj), rtol=0, atol=F32_TOL)
    cj, ct = jm.zero_cache(cfg_j, 2, 8), tm.zero_cache(cfg_t, 2, 8,
                                                       device="cpu")
    step_j = jax.jit(jm.make_decode_step(cfg_j))
    step_t = tm.make_decode_step(cfg_t)
    for i in range(3):
        lj, cj = step_j(pj, cj, jnp.asarray(tokens[:, i:i + 1]), jnp.int32(i))
        lt, ct = step_t(pt, ct, torch.as_tensor(tokens[:, i:i + 1]), i)
        np.testing.assert_allclose(_np(lt), _np(lj), rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_float8_kv_cache_decode_matches_the_reference(compute, monkeypatch):
    """qwen2-7b's smoke config with ``kv_dtype="float8_e4m3fn"`` (the
    hillclimb's last qwen2-7b step): the cache is float8 on both sides and
    the decode logits agree within the compute type's tolerance. In
    float32 the cache is bit for bit the reference's; in bf16 the two
    packages' bf16 K/V differ in their last bits, which moves an entry
    across a float8 rounding boundary here and there (at most 5 % of the
    entries differ, each within the bf16 tolerance plus one float8 step)."""
    if compute == "float32":
        for mod, val in ((jl, jnp.float32), (jm, jnp.float32),
                         (tl, torch.float32), (tm, torch.float32)):
            monkeypatch.setattr(mod, "CDT", val)
    kw = {"kv_dtype": "float8_e4m3fn"}
    cfg_j, cfg_t = j_smoke_config("qwen2-7b", **kw), smoke_config("qwen2-7b",
                                                                   **kw)
    pj = jm.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = tm.params_from_reference(jax.tree.map(np.asarray, pj), device="cpu")
    B, Smax, steps = 3, 24, 6
    tokens = _tokens(cfg_j, (B, steps), seed=2)
    cj = jm.zero_cache(cfg_j, B, Smax)
    ct = tm.zero_cache(cfg_t, B, Smax, device="cpu")
    assert ct["kv"][0].dtype == torch.float8_e4m3fn
    assert str(cj["kv"][0].dtype) == "float8_e4m3fn"
    step_j = jax.jit(jm.make_decode_step(cfg_j))
    step_t = tm.make_decode_step(cfg_t)
    for i in range(steps):
        lj, cj = step_j(pj, cj, jnp.asarray(tokens[:, i:i + 1]), jnp.int32(i))
        lt, ct = step_t(pt, ct, torch.as_tensor(tokens[:, i:i + 1]), i)
        tol = F32_TOL if compute == "float32" else bf16_tol(lj)
        np.testing.assert_allclose(_np(lt), _np(lj), rtol=0, atol=tol)
    for a, b in zip(cj["kv"], ct["kv"]):
        a, b = _np(a), _np(b)
        assert not np.any(b[:, :, steps:])
        if compute == "float32":
            assert a.tobytes() == b.tobytes()
            continue
        assert (a != b).mean() <= 0.05
        # each side rounds to float8 within half a step of its value
        big = np.maximum(np.maximum(np.abs(a), np.abs(b)), 2.0 ** -6)
        step = 2.0 ** (np.floor(np.log2(big)) - 3)      # 3 mantissa bits
        assert np.all(np.abs(a - b) <= bf16_tol(a) + step)


def test_prefill_last_logits_equal_the_decode_logits(setup, f32_compute):
    """The two paths of the model agree on one sequence: prefill's last
    position and the decode step that feeds the last token."""
    cfg_j, cfg_t, pj, _, pt = setup
    tokens = _tokens(cfg_j, (1, 12), seed=3)
    last, _ = tm.make_prefill(cfg_t)(pt, {"tokens": torch.as_tensor(tokens)})
    cache = tm.zero_cache(cfg_t, 1, 16, device="cpu")
    step = tm.make_decode_step(cfg_t)
    for i in range(tokens.shape[1]):
        logits, cache = step(pt, cache, torch.as_tensor(tokens[:, i:i + 1]),
                             i)
    np.testing.assert_allclose(logits.numpy(), last.numpy(), rtol=0,
                               atol=F32_TOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _record(engine):
    """Wrap the engine's decode step to keep every step's logits."""
    seen = []
    decode = engine.decode

    def wrapped(*args):
        logits, cache = decode(*args)
        seen.append(_np(logits))
        return logits, cache

    engine.decode = wrapped
    return seen


def test_serving_engine_teacher_forced_matches_the_reference(setup):
    _check_teacher_forced_engine(setup)


def _check_teacher_forced_engine(setup):
    """Both engines admit three prompts and decode to the end; the port's
    sampled tokens are replaced by the reference's (teacher forcing), and
    every decode step's logits must agree within bf16 noise."""
    cfg_j, cfg_t, pj, _, pt = setup
    jeng = JServingEngine(cfg_j, pj, n_slots=3, max_seq=48)
    teng = ServingEngine(cfg_t, pt, n_slots=3, max_seq=48)
    seen_j, seen_t = _record(jeng), _record(teng)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg_j.vocab, n).tolist() for n in (5, 9, 3)]
    for i, prompt in enumerate(prompts):
        assert jeng.admit(JGenRequest(seq_id=i, prompt=prompt, max_new=6 + i))
        assert teng.admit(GenRequest(seq_id=i, prompt=prompt, max_new=6 + i))
    assert not teng.admit(GenRequest(seq_id=9, prompt=[1], max_new=1))
    compared = agreed = 0
    while any(not r.done for r in jeng.requests.values()):
        n_j, n_t = jeng.tick(), teng.tick()
        assert n_j == n_t
        for seq_id, rj in jeng.requests.items():
            rt = teng.requests[seq_id]
            assert len(rt.out) == len(rj.out) and rt.done == rj.done
            if rt.out and rt.out[-1] != rj.out[-1]:
                rt.out[-1] = rj.out[-1]            # teacher forcing
        np.copyto(teng.last_token, jeng.last_token)
    assert len(seen_t) == len(seen_j) > 0
    tol = bf16_tol(np.stack(seen_j))
    for lj, lt in zip(seen_j, seen_t):
        np.testing.assert_allclose(lt, lj, rtol=0, atol=tol)
        for row_j, row_t in zip(lj, lt):
            top2 = np.sort(row_j)[-2:]
            if top2[1] - top2[0] > 2 * tol:
                compared += 1
                agreed += int(np.argmax(row_t) == np.argmax(row_j))
    assert compared > 0 and agreed == compared
    np.testing.assert_array_equal(teng.lengths, jeng.lengths)
    assert teng.state_fingerprint() == jeng.state_fingerprint()
    assert teng.pool.n_free == jeng.pool.n_free == 3


def test_engine_reproduces_the_references_cache_overwrite(setup):
    """Stepping one slot writes every slot's K/V at that slot's position
    (`serving/engine.py:76-83` with `transformer.py:140-146`): admitting
    [9, 10] into slot 1 rewrites slot 0's cache at positions 0 and 1."""
    cfg_j, cfg_t, pj, _, pt = setup
    jeng = JServingEngine(cfg_j, pj, n_slots=2, max_seq=16)
    teng = ServingEngine(cfg_t, pt, n_slots=2, max_seq=16)
    for eng, req in ((jeng, JGenRequest), (teng, GenRequest)):
        eng.admit(req(seq_id=0, prompt=[5, 6, 7, 8], max_new=2))
    before_j = _np(jeng.cache["kv"][0])[:, 0].copy()
    before_t = _np(teng.cache["kv"][0])[:, 0].copy()
    for eng, req in ((jeng, JGenRequest), (teng, GenRequest)):
        eng.admit(req(seq_id=1, prompt=[9, 10], max_new=2))
    after_j = _np(jeng.cache["kv"][0])[:, 0]
    after_t = _np(teng.cache["kv"][0])[:, 0]
    for before, after in ((before_j, after_j), (before_t, after_t)):
        assert not np.array_equal(before[:, :2], after[:, :2])
        np.testing.assert_array_equal(before[:, 2:], after[:, 2:])
    np.testing.assert_allclose(after_t, after_j, rtol=0,
                               atol=bf16_tol(after_j))
    np.testing.assert_array_equal(teng.lengths, [4, 2])


def test_engine_reproduces_the_references_slot_reuse(setup):
    """A released slot admitted again keeps its old length
    (`serving/engine.py:57, 82` never resets `lengths[slot]`): with one
    slot, a 4-token prompt and one new token leave length 5, and the next
    request's 2-token prompt starts there and ends at 7, attending the
    first request's stale K/V. Both packages, the same logits."""
    cfg_j, cfg_t, pj, _, pt = setup
    jeng = JServingEngine(cfg_j, pj, n_slots=1, max_seq=32)
    teng = ServingEngine(cfg_t, pt, n_slots=1, max_seq=32)
    seen_j, seen_t = _record(jeng), _record(teng)
    lengths = []
    for eng, req in ((jeng, JGenRequest), (teng, GenRequest)):
        assert eng.admit(req(seq_id=0, prompt=[5, 6, 7, 8], max_new=1))
        eng.tick()
        first = eng.lengths.tolist()
        assert eng.requests[0].done and eng.pool.n_free == 1
        assert eng.admit(req(seq_id=1, prompt=[9, 10], max_new=1))
        lengths.append((first, eng.lengths.tolist()))
    assert lengths == [([5], [7]), ([5], [7])]
    assert len(seen_t) == len(seen_j) == 7
    tol = bf16_tol(np.stack(seen_j))
    for lj, lt in zip(seen_j, seen_t):
        np.testing.assert_allclose(lt, lj, rtol=0, atol=tol)


@pytest.fixture(scope="module")
def granite():
    """granite-20b at smoke size: dense, learned positions, max_seq 512."""
    cfg_j, cfg_t = j_smoke_config("granite-20b"), smoke_config("granite-20b")
    assert cfg_t.pos == "learned" and cfg_t.max_seq == 512
    pj = jm.init_params(cfg_j, jax.random.PRNGKey(1))
    pt = tm.params_from_reference(jax.tree.map(np.asarray, pj), device="cpu")
    return cfg_j, cfg_t, pj, pt


@pytest.mark.parametrize("cache_len", [510, 511, 512, 513])
def test_decode_past_the_position_table_clamps_as_the_reference(granite,
                                                               cache_len):
    """The reference's `dynamic_slice_in_dim` clamps the learned-position
    row into the table (`repro/models/model.py:154-156`): at cache_len 512
    and 513 both packages add row 511. One row, a KV cache 520 long filled
    with the same seeded values in both."""
    cfg_j, cfg_t, pj, pt = granite
    cj = jm.zero_cache(cfg_j, 1, 520)
    shape = cj["kv"][0].shape
    rng = np.random.default_rng(cache_len)
    k, v = (rng.standard_normal(shape, dtype=np.float32) for _ in range(2))
    cj = {"kv": tuple(jnp.asarray(a).astype(jnp.bfloat16) for a in (k, v))}
    ct = {"kv": tuple(torch.as_tensor(a).to(torch.bfloat16) for a in (k, v))}
    token = _tokens(cfg_j, (1, 1), seed=cache_len)
    lj, _ = jm.make_decode_step(cfg_j)(pj, cj, jnp.asarray(token),
                                       jnp.int32(cache_len))
    lt, _ = tm.make_decode_step(cfg_t)(pt, ct, torch.as_tensor(token),
                                       cache_len)
    assert lt.shape == (1, cfg_t.vocab)
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=0, atol=bf16_tol(lj))


def test_prefill_past_the_position_table_clamps_as_the_reference(granite):
    """A prefill whose pos_offset + S passes the table takes its last S rows
    in both packages (`repro/models/transformer.py:264-266`)."""
    from repro.models.transformer import decoder_forward as j_forward

    cfg_j, cfg_t, pj, pt = granite
    tokens = _tokens(cfg_j, (1, 8), seed=6)
    hj, _ = j_forward(pj, jnp.asarray(tokens), cfg_j, pos_offset=508)
    ht, aux = ttf.decoder_forward(pt, torch.as_tensor(tokens), cfg_t,
                                  pos_offset=508)
    assert float(aux) == 0.0                   # no MoE layer
    assert ht.shape == (1, 8, cfg_t.d_model)
    np.testing.assert_allclose(_np(ht), _np(hj), rtol=0, atol=bf16_tol(hj))


def test_slot_pool_and_prefill_write():
    pool = SlotPool(2)
    assert [pool.alloc(7), pool.alloc(8), pool.alloc(9)] == [0, 1, None]
    pool.release(0)
    assert pool.active() == [1] and pool.n_free == 1
    assert pool.alloc(10) == 0
    cfg = smoke_config(ARCH)
    cache = tm.zero_cache(cfg, 3, 8, device="cpu")
    seq = {"kv": tuple(torch.ones(cfg.n_layers, 1, 8, cfg.n_kv_heads,
                                  cfg.resolved_head_dim) for _ in range(2))}
    out = write_prefill_into_cache(cache, 1, seq)
    k = out["kv"][0]
    assert k.dtype == torch.bfloat16
    assert bool((k[:, 1] == 1).all()) and not bool(k[:, [0, 2]].any())


# ---------------------------------------------------------------------------
# the ssm family: mamba2-130m at smoke size
# ---------------------------------------------------------------------------
SSM = "mamba2-130m"


@pytest.fixture(scope="module")
def ssm_setup():
    cfg_j, cfg_t = j_smoke_config(SSM), smoke_config(SSM)
    pj = jm.init_params(cfg_j, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, pj)
    pt = tm.params_from_reference(tree, device="cpu")
    return cfg_j, cfg_t, pj, tree, pt


def test_ssm_family_count_and_cache_have_no_attention():
    assert tm.count_params(get_config(SSM)) == 128_940_480
    assert set(tm.zero_cache(smoke_config(SSM), 1, 8, device="cpu")) == \
        {"mamba"}
    assert set(tm.zero_cache(smoke_config("hymba-1.5b"), 1, 8,
                             device="cpu")) == {"kv", "mamba"}


def test_ssm_params_from_reference_round_trip_every_leaf(ssm_setup):
    _, _, _, tree, pt = ssm_setup
    leaves_j = jax.tree_util.tree_leaves_with_path(tree)
    leaves_t = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), pt))
    assert [p for p, _ in leaves_j] == [p for p, _ in leaves_t]
    assert "norm_m" in pt["layers"] and "A_log" in pt["layers"]["mamba"]
    for (_, a), (_, b) in zip(leaves_j, leaves_t):
        assert b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_ssm_init_params_has_the_references_distributions(ssm_setup):
    cfg_j, cfg_t, pj, _, _ = ssm_setup
    got = tm.init_params(cfg_t, seed=0, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), pj) == \
        jax.tree.map(lambda t: tuple(t.shape), got)
    m, mj = got["layers"]["mamba"], pj["layers"]["mamba"]
    # A_log = log(linspace(1, 16, H)) in every layer; D, out_norm 1; dt_bias 0
    np.testing.assert_allclose(m["A_log"].numpy(), np.asarray(mj["A_log"]),
                               rtol=0, atol=1e-6)
    assert m["A_log"].shape[0] == cfg_t.n_layers
    for name in ("D", "out_norm", "dt_bias"):
        np.testing.assert_array_equal(m[name].numpy(), np.asarray(mj[name]))
    assert bool((m["D"] == 1).all()) and not bool(m["dt_bias"].any())
    w = m["in_proj"]                           # [L, d, e]: fan_in d
    assert abs(float(w.std()) * cfg_t.d_model ** 0.5 - 1.0) < 0.05


def test_ssm_cache_has_the_references_tree(ssm_setup):
    cfg_j, cfg_t, _, _, _ = ssm_setup
    cj = jm.zero_cache(cfg_j, 3, 24)
    ct = tm.zero_cache(cfg_t, 3, 24, device="cpu")
    assert set(ct) == set(cj) == {"mamba"}
    for key in ("h", "conv"):
        a, b = cj["mamba"][key], ct["mamba"][key]
        assert tuple(b.shape) == a.shape
        assert str(b.dtype).split(".")[-1] == str(a.dtype)
        assert not bool(b.any())
    meta = tm.abstract_cache(cfg_t, 3, 24)["mamba"]["h"]
    assert meta.device.type == "meta" and meta.dtype == torch.float32


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_ssm_prefill_matches_the_reference(ssm_setup, compute, monkeypatch):
    if compute == "float32":
        for mod, val in ((jl, jnp.float32), (jm, jnp.float32),
                         (tl, torch.float32), (tm, torch.float32)):
            monkeypatch.setattr(mod, "CDT", val)
    tokens = _tokens(ssm_setup[0], (2, 37), seed=0)     # ragged: 2 chunks + 5
    (lj, hj), (lt, ht) = _prefill_both(ssm_setup, tokens)
    assert lt.shape == (2, ssm_setup[0].vocab)
    assert ht.shape == (2, 37, ssm_setup[0].d_model)
    for got, want in ((lt, lj), (ht, hj)):
        tol = F32_TOL if compute == "float32" else bf16_tol(want)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_ssm_decode_step_matches_the_reference(ssm_setup, compute,
                                               monkeypatch):
    if compute == "float32":
        for mod, val in ((jl, jnp.float32), (jm, jnp.float32),
                         (tl, torch.float32), (tm, torch.float32)):
            monkeypatch.setattr(mod, "CDT", val)
    cfg_j, cfg_t, pj, _, pt = ssm_setup
    B, steps = 3, 6
    tokens = _tokens(cfg_j, (B, steps), seed=2)
    cj = jm.zero_cache(cfg_j, B, 16)
    ct = tm.zero_cache(cfg_t, B, 16, device="cpu")
    h_t, conv_t = ct["mamba"]["h"], ct["mamba"]["conv"]
    step_j = jax.jit(jm.make_decode_step(cfg_j))
    step_t = tm.make_decode_step(cfg_t)
    for i in range(steps):
        lj, cj = step_j(pj, cj, jnp.asarray(tokens[:, i:i + 1]), jnp.int32(i))
        lt, ct = step_t(pt, ct, torch.as_tensor(tokens[:, i:i + 1]), i)
        tol = F32_TOL if compute == "float32" else bf16_tol(lj)
        np.testing.assert_allclose(_np(lt), _np(lj), rtol=0, atol=tol)
    # the cache was updated in place and returned
    assert ct["mamba"]["h"] is h_t and ct["mamba"]["conv"] is conv_t
    for key in ("h", "conv"):
        a, b = cj["mamba"][key], ct["mamba"][key]
        tol = F32_TOL if compute == "float32" else bf16_tol(a)
        np.testing.assert_allclose(_np(b), _np(a), rtol=0, atol=tol)


def test_ssm_prefill_last_logits_equal_the_decode_logits(ssm_setup,
                                                         f32_compute):
    """Prefill's last position (the chunked scan) and the decode step that
    feeds the last token (the recurrence) agree on one sequence."""
    cfg_j, cfg_t, pj, _, pt = ssm_setup
    tokens = _tokens(cfg_j, (1, 21), seed=3)
    last, _ = tm.make_prefill(cfg_t)(pt, {"tokens": torch.as_tensor(tokens)})
    cache = tm.zero_cache(cfg_t, 1, 32, device="cpu")
    step = tm.make_decode_step(cfg_t)
    for i in range(tokens.shape[1]):
        logits, cache = step(pt, cache, torch.as_tensor(tokens[:, i:i + 1]),
                             i)
    np.testing.assert_allclose(logits.numpy(), last.numpy(), rtol=0,
                               atol=F32_TOL)


def test_ssm_serving_engine_teacher_forced_matches_the_reference(ssm_setup):
    _check_teacher_forced_engine(ssm_setup)


def test_engine_reproduces_the_references_ssm_state_advance(ssm_setup):
    """Stepping one slot advances every slot's SSM state
    (`serving/engine.py:76-83`: the other rows are fed token 0): admitting
    [9, 10] into slot 1 moves slot 0's h and conv on by two steps of token
    0, in both packages."""
    cfg_j, cfg_t, pj, _, pt = ssm_setup
    jeng = JServingEngine(cfg_j, pj, n_slots=2, max_seq=16)
    teng = ServingEngine(cfg_t, pt, n_slots=2, max_seq=16)
    for eng, req in ((jeng, JGenRequest), (teng, GenRequest)):
        eng.admit(req(seq_id=0, prompt=[5, 6, 7, 8], max_new=2))
    before = {key: _np(teng.cache["mamba"][key])[:, 0].copy()
              for key in ("h", "conv")}
    for eng, req in ((jeng, JGenRequest), (teng, GenRequest)):
        eng.admit(req(seq_id=1, prompt=[9, 10], max_new=2))
    # slot 0 alone, stepped on with token 0 twice, lands where it did
    solo = tm.zero_cache(cfg_t, 1, 16, device="cpu")
    step = tm.make_decode_step(cfg_t)
    for i, t in enumerate([5, 6, 7, 8, 0, 0]):
        _, solo = step(pt, solo, torch.as_tensor([[t]]), i)
    for key in ("h", "conv"):
        after_t = _np(teng.cache["mamba"][key])[:, 0]
        after_j = _np(jeng.cache["mamba"][key])[:, 0]
        assert not np.array_equal(before[key], after_t)
        want = _np(solo["mamba"][key])[:, 0]
        np.testing.assert_allclose(after_t, want, rtol=0, atol=bf16_tol(want))
        np.testing.assert_allclose(after_t, after_j, rtol=0,
                                   atol=bf16_tol(after_j))
    np.testing.assert_array_equal(teng.lengths, [4, 2])
    np.testing.assert_array_equal(teng.lengths, jeng.lengths)
