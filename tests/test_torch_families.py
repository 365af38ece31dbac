"""The port's remaining model families against the reference's, at
`smoke_config` size: hybrid (hymba-1.5b: window 64, SSM N 16 P 16 chunk
16), MoE (dbrx-132b: 4 experts top-2; arctic-480b: the same plus the dense
residual MLP), encoder-decoder (seamless-m4t-large-v2: 2 + 2 layers, 8
source frames, layer norm, gelu, qkv biases, learned positions) and vision
frontend (phi-3-vision-4.2b: 8 patch embeddings before the text).

Both packages get the same parameters (the reference's `init_params`,
carried across with `params_from_reference`) and the same numpy-seeded
tokens, frames and patches. Tolerances (as `tests/test_torch_lm.py`):
- float32 compute (both packages' compute dtype set to float32): 1e-4 --
  the same arithmetic, summed in another order;
- bf16 compute: 2^-5 of the largest magnitude of the compared logits.
  hymba's bf16 test compares logits, not the hidden stream: its hidden
  state carries the attention and SSM branches' bf16 roundings through
  two RMS norms each layer and differs by more than 2^-5 of its largest
  value, while the logits stay well inside it.
The MoE layer is also held alone: `moe_ffn` with a capacity small enough
that assignments drop, against `reference_moe` with none, and on tied
router probabilities (the lower expert index first, as `lax.top_k`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jl
import repro.models.model as jm
import repro.models.moe as jmoe
import repro.models.transformer as jtf
import repro_torch.models.layers as tl
import repro_torch.models.model as tm
import repro_torch.models.moe as tmoe
import repro_torch.models.transformer as ttf
from repro.configs import smoke_config as j_smoke_config
from repro.serving.engine import GenRequest as JGenRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs import smoke_config
from repro_torch.serving.engine import GenRequest, ServingEngine
from test_torch_lm import (
    F32_TOL,
    _check_teacher_forced_engine,
    _np,
    _record,
    _tokens,
    bf16_tol,
)

FAMILIES = ["hymba-1.5b", "dbrx-132b", "arctic-480b",
            "seamless-m4t-large-v2", "phi-3-vision-4.2b"]


def _set_compute(monkeypatch, compute: str) -> None:
    """Both packages compute in ``compute`` (float32: the algorithm, not
    the rounding)."""
    if compute == "float32":
        for mod in (jl, jm, jtf):
            monkeypatch.setattr(mod, "CDT", jnp.float32)
        for mod in (tl, tm):
            monkeypatch.setattr(mod, "CDT", torch.float32)


@pytest.fixture
def f32_compute(monkeypatch):
    _set_compute(monkeypatch, "float32")


@pytest.fixture(scope="module", params=FAMILIES)
def fam(request):
    name = request.param
    cfg_j, cfg_t = j_smoke_config(name), smoke_config(name)
    pj = jm.init_params(cfg_j, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, pj)
    pt = tm.params_from_reference(tree, device="cpu")
    return cfg_j, cfg_t, pj, tree, pt


def _embeds(cfg, seed):
    """The encoder's source frames or the vision patches, [2, F, d]."""
    return np.random.default_rng(seed).standard_normal(
        (2, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32)


def _batches(cfg, tokens, seed=7):
    bj, bt = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.as_tensor(
        tokens)}
    if cfg.frontend:
        key = "src" if cfg.enc_dec else "frontend"
        emb = _embeds(cfg, seed)[:tokens.shape[0]]
        bj[key], bt[key] = jnp.asarray(emb), torch.as_tensor(emb)
    return bj, bt


def _prompt_len(cfg) -> int:
    """Prompts cross hymba's window of 64 (smoke), the others are short."""
    return 80 if cfg.window else 19


# ---------------------------------------------------------------------------
# parameters and caches
# ---------------------------------------------------------------------------
def test_params_round_trip_every_leaf(fam):
    cfg_j, cfg_t, pj, tree, pt = fam
    leaves_j = jax.tree_util.tree_leaves_with_path(tree)
    leaves_t = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), pt))
    assert [p for p, _ in leaves_j] == [p for p, _ in leaves_t]
    for (_, a), (_, b) in zip(leaves_j, leaves_t):
        assert b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    got = tm.init_params(cfg_t, seed=0, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), pj) == \
        jax.tree.map(lambda t: tuple(t.shape), got)
    new = {"hybrid": ("mamba", "branch_norm_a", "branch_norm_m"),
           "moe": ("moe",), "audio": ("xattn", "ln_x"),
           "vlm": ()}[cfg_t.family]
    assert set(new) <= set(pt["layers"])
    if cfg_t.enc_dec:
        assert {"enc_layers", "enc_final_norm", "pos_embed"} <= set(pt)
    assert tm.count_params(cfg_t) == jm.count_params(cfg_j)
    assert tm.count_params(cfg_t, active_only=True) == \
        jm.count_params(cfg_j, active_only=True)


def test_zero_cache_has_the_references_tree(fam):
    cfg_j, cfg_t = fam[:2]
    for src_len in (0, 5):
        cj = jm.zero_cache(cfg_j, 3, 24, src_len)
        ct = tm.zero_cache(cfg_t, 3, 24, src_len, device="cpu")
        leaves_j = jax.tree_util.tree_leaves_with_path(cj)
        leaves_t = jax.tree_util.tree_leaves_with_path(ct)
        assert [p for p, _ in leaves_j] == [p for p, _ in leaves_t]
        for (_, a), (_, b) in zip(leaves_j, leaves_t):
            assert tuple(b.shape) == a.shape and not bool(b.any())
            assert str(b.dtype).split(".")[-1] == str(a.dtype)


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------
class _ReplayRouting:
    """Records the reference's top-k experts of every `moe_ffn` call (in
    layer order, in `lax.top_k`'s order) and forces them on the port's
    `moe.top_k` in the same order, counting each token whose own top-k
    set differs. Such a token may take the reference's experts only on a
    near-tie: its own top-k mass and the forced set's agree within 2^-6
    of its own (a few bf16 units of the router's input)."""

    def __init__(self, monkeypatch):
        self.picked, self.flips = [], 0
        self.top_k, ffn_j = tmoe.top_k, jmoe.moe_ffn

        def wrap_j(x, p, **kw):
            _, e = jax.lax.top_k(jmoe.router(x, p["w_router"])[0],
                                 kw["top_k"])
            jax.debug.callback(lambda v: self.picked.append(np.array(v)), e)
            return ffn_j(x, p, **kw)

        monkeypatch.setattr(jmoe, "moe_ffn", wrap_j)
        monkeypatch.setattr(tmoe, "top_k", self)

    def __call__(self, probs, k):
        vals, idx = self.top_k(probs, k)
        forced = torch.as_tensor(self.picked.pop(0), dtype=idx.dtype)
        own = torch.sort(idx, -1).values != torch.sort(forced, -1).values
        self.flips += int(own.any(-1).sum())
        mass = probs.gather(-1, forced).sum(-1)
        assert bool((vals.sum(-1) - mass <= 2 ** -6 * vals.sum(-1)).all())
        return probs.gather(-1, forced), forced


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_prefill_matches_the_reference(fam, compute, monkeypatch):
    """Logits within 1e-4 (float32) or 2^-5 of the largest (bf16), every
    row; the hidden stream too in float32.

    MoE: top-k routing is a step function of its input, and the two
    frameworks' bf16 roundings differ by a unit in the last place here and
    there, so a token whose k-th and (k+1)-th router probabilities all but
    tie can take another expert in one package (seed 0 has one, in dbrx's
    first layer: 0.1950 against 0.1933), and its row's logits then move by
    more than rounding noise. So the port takes the reference's experts
    (`_ReplayRouting`): every token that would have picked another set must
    be a near-tie, and in float32 no token may."""
    _set_compute(monkeypatch, compute)
    cfg_j, cfg_t, pj, _, pt = fam
    routing = _ReplayRouting(monkeypatch) if cfg_t.family == "moe" else None
    tokens = _tokens(cfg_j, (2, _prompt_len(cfg_j)), seed=0)
    bj, bt = _batches(cfg_j, tokens)
    lj, hj = jm.make_prefill(cfg_j)(pj, bj)
    if routing is not None:
        jax.effects_barrier()
        assert len(routing.picked) == cfg_t.n_layers
    lt, ht = tm.make_prefill(cfg_t)(pt, bt)
    if routing is not None:
        assert routing.picked == []
        assert compute == "bfloat16" or routing.flips == 0
    n_hidden = tokens.shape[1] + (cfg_t.n_frontend_tokens
                                  if cfg_t.frontend == "vision" else 0)
    assert lt.shape == (2, cfg_t.vocab)
    assert ht.shape == (2, n_hidden, cfg_t.d_model)
    tol = F32_TOL if compute == "float32" else bf16_tol(lj)
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=0, atol=tol)
    if compute == "float32":
        np.testing.assert_allclose(_np(ht), _np(hj), rtol=0, atol=F32_TOL)
    if compute == "float32" and cfg_t.family == "moe":
        # the load-balancing loss, summed over the layers
        _, aux_j = jtf.decoder_forward(pj, bj["tokens"], cfg_j)
        _, aux_t = ttf.decoder_forward(pt, bt["tokens"], cfg_t)
        assert float(aux_j) > 0
        np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)


def _cross_cache(cfg_j, pj, B):
    """The reference's cross-attention K/V of seeded source frames, as
    the decode cache's "cross" entry (numpy, the cache's dtype)."""
    src = jnp.asarray(_embeds(cfg_j, 11)[:1].repeat(B, 0))
    ek, ev = jtf.cross_kv(pj, jtf.encoder_forward(pj, src, cfg_j), cfg_j)
    return tuple(np.array(a.astype(jnp.float32)) for a in (ek, ev))


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_decode_step_matches_the_reference(fam, compute, monkeypatch):
    """Six steps of three rows from a zero cache (the encoder-decoder's
    cross cache filled from an encoder run); every step's logits and the
    final cache agree."""
    _set_compute(monkeypatch, compute)
    cfg_j, cfg_t, pj, _, pt = fam
    B, Smax, steps = 3, 24, 6
    tokens = _tokens(cfg_j, (B, steps), seed=2)
    cj = jm.zero_cache(cfg_j, B, Smax)
    ct = tm.zero_cache(cfg_t, B, Smax, device="cpu")
    if cfg_t.enc_dec:
        ek, ev = _cross_cache(cfg_j, pj, B)
        dt = ct["cross"][0].dtype
        cj["cross"] = tuple(jnp.asarray(a).astype(cj["cross"][0].dtype)
                            for a in (ek, ev))
        ct["cross"] = tuple(torch.as_tensor(a).to(dt) for a in (ek, ev))
    step_j = jax.jit(jm.make_decode_step(cfg_j))
    step_t = tm.make_decode_step(cfg_t)
    for i in range(steps):
        lj, cj = step_j(pj, cj, jnp.asarray(tokens[:, i:i + 1]), jnp.int32(i))
        lt, ct = step_t(pt, ct, torch.as_tensor(tokens[:, i:i + 1]), i)
        tol = F32_TOL if compute == "float32" else bf16_tol(lj)
        np.testing.assert_allclose(_np(lt), _np(lj), rtol=0, atol=tol)
    leaves_j = jax.tree_util.tree_leaves(cj)
    leaves_t = jax.tree_util.tree_leaves(ct)
    assert len(leaves_j) == len(leaves_t)
    for a, b in zip(leaves_j, leaves_t):
        tol = F32_TOL if compute == "float32" else bf16_tol(a)
        np.testing.assert_allclose(_np(b), _np(a), rtol=0, atol=tol)


def test_prefill_last_logits_equal_the_decode_logits(fam, f32_compute):
    """The port's two paths agree on one sequence: prefill's last position
    and the decode step that feeds the last token (hymba's 80-token prompt
    crosses its window of 64 in both; the encoder-decoder decodes against
    the cross K/V of the frames prefill encodes; the vision model's prefill
    takes no patches, as its decode cannot). MoE runs with a capacity that
    holds every assignment: prefill drops the assignments past an expert's
    capacity by design, and a one-token decode step never does."""
    _, cfg_t, _, _, pt = fam
    if cfg_t.family == "moe":
        # C = 2 T k // 8 * 8 >= T slots an expert: nothing drops
        cfg_t = dataclasses.replace(cfg_t,
                                    capacity_factor=2.0 * cfg_t.n_experts)
    tokens = _tokens(cfg_t, (1, _prompt_len(cfg_t)), seed=3)
    batch = {"tokens": torch.as_tensor(tokens)}
    cache = tm.zero_cache(cfg_t, 1, 96, device="cpu")
    if cfg_t.enc_dec:
        batch["src"] = torch.as_tensor(_embeds(cfg_t, 5)[:1])
        enc = ttf.encoder_forward(pt, batch["src"], cfg_t)
        cache["cross"] = ttf.cross_kv(pt, enc, cfg_t)
    last, _ = tm.make_prefill(cfg_t)(pt, batch)
    step = tm.make_decode_step(cfg_t)
    for i in range(tokens.shape[1]):
        logits, cache = step(pt, cache, torch.as_tensor(tokens[:, i:i + 1]),
                             i)
    np.testing.assert_allclose(logits.numpy(), last.numpy(), rtol=0,
                               atol=F32_TOL)


def test_serving_engine_teacher_forced_matches_the_reference(fam):
    _check_teacher_forced_engine(fam)


def test_dense_config_with_a_window_matches_the_reference(f32_compute):
    """tinyllama at smoke size with window=64: prefill of 100 tokens, and
    100 decode steps, whose last logits equal the reference's decode and
    the port's prefill (the decode mask keeps the last 64 positions, as
    prefill's band does)."""
    cfg_j = dataclasses.replace(j_smoke_config("tinyllama-1.1b"), window=64)
    cfg_t = dataclasses.replace(smoke_config("tinyllama-1.1b"), window=64)
    pj = jm.init_params(cfg_j, jax.random.PRNGKey(2))
    pt = tm.params_from_reference(jax.tree.map(np.asarray, pj), device="cpu")
    tokens = _tokens(cfg_j, (1, 100), seed=8)
    lj, hj = jm.make_prefill(cfg_j)(pj, {"tokens": jnp.asarray(tokens)})
    lt, ht = tm.make_prefill(cfg_t)(pt, {"tokens": torch.as_tensor(tokens)})
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(_np(ht), _np(hj), rtol=0, atol=F32_TOL)
    cj = jm.zero_cache(cfg_j, 1, 128)
    ct = tm.zero_cache(cfg_t, 1, 128, device="cpu")
    step_j = jax.jit(jm.make_decode_step(cfg_j))
    step_t = tm.make_decode_step(cfg_t)
    for i in range(tokens.shape[1]):
        dj, cj = step_j(pj, cj, jnp.asarray(tokens[:, i:i + 1]), jnp.int32(i))
        dt, ct = step_t(pt, ct, torch.as_tensor(tokens[:, i:i + 1]), i)
    np.testing.assert_allclose(_np(dt), _np(dj), rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(_np(dt), _np(lt), rtol=0, atol=F32_TOL)
    # the window matters: without it the last logits move
    full, _ = tm.make_prefill(smoke_config("tinyllama-1.1b"))(
        pt, {"tokens": torch.as_tensor(tokens)})
    assert float((full - lt).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# serving behaviours of the reference kept on purpose
# ---------------------------------------------------------------------------
def _setup(name):
    cfg_j, cfg_t = j_smoke_config(name), smoke_config(name)
    pj = jm.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = tm.params_from_reference(jax.tree.map(np.asarray, pj), device="cpu")
    return cfg_j, cfg_t, pj, pt


def test_engine_serves_seamless_against_an_all_zero_cross_cache():
    """The reference's `ServingEngine` builds its cache with no source
    length (`repro/serving/engine.py:46`, `model.py:135-139`): the cross
    cache is ``n_frontend_tokens`` frames of zeros and stays so, every
    cross-attention reads zeros and adds nothing. Both packages, the same
    logits; and the port's first step equals, bit for bit, a step whose
    cross-attention reads seeded random K/V through a zero output
    projection."""
    cfg_j, cfg_t, pj, pt = _setup("seamless-m4t-large-v2")
    jeng = JServingEngine(cfg_j, pj, n_slots=2, max_seq=16)
    teng = ServingEngine(cfg_t, pt, n_slots=2, max_seq=16)
    seen_j, seen_t = _record(jeng), _record(teng)
    for eng, req in ((jeng, JGenRequest), (teng, GenRequest)):
        assert eng.admit(req(seq_id=0, prompt=[5, 6, 7], max_new=3))
        eng.tick()
    shape = (cfg_t.n_layers, 2, cfg_t.n_frontend_tokens, cfg_t.n_kv_heads,
             cfg_t.resolved_head_dim)
    for eng in (jeng, teng):
        for part in eng.cache["cross"]:
            assert tuple(part.shape) == shape and not np.any(_np(part))
    assert len(seen_t) == len(seen_j) == 4
    tol = bf16_tol(np.stack(seen_j))
    for lj, lt in zip(seen_j, seen_t):
        np.testing.assert_allclose(lt, lj, rtol=0, atol=tol)
    # without the cross blocks' contribution: the same first-step logits
    no_cross = {**pt, "layers": {**pt["layers"], "xattn": {
        **pt["layers"]["xattn"],
        "wo": torch.zeros_like(pt["layers"]["xattn"]["wo"])}}}
    cache = tm.zero_cache(cfg_t, 2, 16, device="cpu")
    rng = np.random.default_rng(12)
    cache["cross"] = tuple(torch.as_tensor(rng.standard_normal(
        shape, dtype=np.float32)).to(cache["cross"][0].dtype)
        for _ in range(2))
    want, _ = tm.make_decode_step(cfg_t)(no_cross, cache,
                                         torch.tensor([[5], [0]]), 0)
    np.testing.assert_array_equal(seen_t[0], _np(want))


def test_engine_serves_phi3_vision_text_only(f32_compute):
    """The reference's decode step has no frontend, so its engine serves
    text alone: a one-slot engine's logits after admitting a prompt equal
    `make_prefill`'s last logits for the prompt without patches, and not
    with them (float32 compute)."""
    cfg_j, cfg_t, pj, pt = _setup("phi-3-vision-4.2b")
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    jeng = JServingEngine(cfg_j, pj, n_slots=1, max_seq=16)
    teng = ServingEngine(cfg_t, pt, n_slots=1, max_seq=16)
    seen = [_record(jeng), _record(teng)]
    jeng.admit(JGenRequest(seq_id=0, prompt=prompt, max_new=1))
    teng.admit(GenRequest(seq_id=0, prompt=prompt, max_new=1))
    prefill = tm.make_prefill(cfg_t)
    text, _ = prefill(pt, {"tokens": torch.as_tensor([prompt])})
    patches = torch.as_tensor(_embeds(cfg_t, 13)[:1])
    both, _ = prefill(pt, {"tokens": torch.as_tensor([prompt]),
                           "frontend": patches})
    for s in seen:
        np.testing.assert_allclose(s[-1], text.numpy(), rtol=0, atol=F32_TOL)
    assert float(np.abs(seen[1][-1] - both.numpy()).max()) > 1e-3


# ---------------------------------------------------------------------------
# the MoE layer alone
# ---------------------------------------------------------------------------
def _moe_inputs(T, d, f, E, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d), dtype=np.float32)
    p = {"w_router": rng.standard_normal((d, E), dtype=np.float32),
         "w_gate": rng.standard_normal((E, d, f), dtype=np.float32) / d ** .5,
         "w_up": rng.standard_normal((E, d, f), dtype=np.float32) / d ** .5,
         "w_down": rng.standard_normal((E, f, d), dtype=np.float32) / f ** .5}
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = torch.as_tensor(x).to(getattr(torch, dtype))
    return (xj, {k: jnp.asarray(v) for k, v in p.items()},
            xt, {k: torch.as_tensor(v) for k, v in p.items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,k", [(4, 2), (16, 4), (8, 1)])
def test_moe_ffn_drops_past_capacity_as_the_reference(E, k, dtype):
    """capacity_factor 0.5: C = max(T k / E / 2 // 8 * 8, 8) slots an
    expert, fewer than the busiest expert's assignments, so some drop.
    Output within 1e-5 (float32) or 2^-5 of its largest (bf16); the aux
    loss within 1e-6."""
    T, d, f = 64, 32, 48
    xj, pj, xt, pt = _moe_inputs(T, d, f, E, seed=E * 10 + k, dtype=dtype)
    C = tmoe.capacity(T, E, k, 0.5)
    _, top_e = tmoe.top_k(tmoe.router(xt, pt["w_router"])[0], k)
    assert int(torch.bincount(top_e.reshape(-1), minlength=E).max()) > C
    oj, aj = jmoe.moe_ffn(xj, pj, n_experts=E, top_k=k, capacity_factor=0.5)
    ot, at = tmoe.moe_ffn(xt, pt, n_experts=E, top_k=k, capacity_factor=0.5)
    assert ot.dtype == xt.dtype and ot.shape == (T, d)
    tol = 1e-5 if dtype == "float32" else bf16_tol(_np(oj))
    np.testing.assert_allclose(_np(ot), _np(oj), rtol=0, atol=tol)
    np.testing.assert_allclose(float(at), float(aj), rtol=0, atol=1e-6)
    # dropped assignments change the output: the dense oracle differs
    dense = tmoe.reference_moe(xt, pt, n_experts=E, top_k=k)
    assert float((dense.float() - ot.float()).abs().max()) > 1e-3


@pytest.mark.parametrize("E,k", [(4, 2), (16, 4), (128, 2)])
def test_moe_ffn_without_drops_equals_the_dense_oracle(E, k):
    """A capacity that holds every assignment: the port's sort-based layer
    equals the reference's dense `reference_moe` (and the port's own
    oracle equals the reference's) within 1e-5, float32."""
    T, d, f = 48, 32, 40
    xj, pj, xt, pt = _moe_inputs(T, d, f, E, seed=E + k)
    cf = float(E)                         # C >= T k: nothing drops
    want = jmoe.reference_moe(xj, pj, n_experts=E, top_k=k)
    got, _ = tmoe.moe_ffn(xt, pt, n_experts=E, top_k=k, capacity_factor=cf)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        _np(tmoe.reference_moe(xt, pt, n_experts=E, top_k=k)), _np(want),
        rtol=0, atol=1e-5)


def test_moe_router_ties_take_the_lower_index():
    """Tied router probabilities: a zero router gives every expert 1 / E,
    and two equal columns tie a pair; `lax.top_k` takes the lower index
    first and so does the port, and the layers agree (float32, 1e-5)."""
    T, d, f, E, k = 16, 8, 12, 6, 2
    xj, pj, xt, pt = _moe_inputs(T, d, f, E, seed=3)
    w = np.asarray(pj["w_router"]).copy()
    for router_w in (np.zeros_like(w), w[:, [0, 4, 2, 4, 1, 4]]):
        pj["w_router"] = jnp.asarray(router_w)
        pt["w_router"] = torch.as_tensor(router_w)
        probs_t, _ = tmoe.router(xt, pt["w_router"])
        probs_j, _ = jmoe.router(xj, pj["w_router"])
        _, want = jax.lax.top_k(probs_j, k)
        _, got = tmoe.top_k(probs_t, k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        oj, _ = jmoe.moe_ffn(xj, pj, n_experts=E, top_k=k)
        ot, _ = tmoe.moe_ffn(xt, pt, n_experts=E, top_k=k)
        np.testing.assert_allclose(_np(ot), _np(oj), rtol=0, atol=1e-5)
    # rows whose top two are the tied pair: the lower index first
    assert [1, 3] in got.tolist()
    zero_top = tmoe.top_k(torch.full((3, E), 1.0 / E), k)[1]
    assert zero_top.tolist() == [[0, 1]] * 3


def test_moe_adds_a_tokens_contributions_in_expert_order():
    """bf16: each token's k weighted expert outputs are added one after
    the other, in ascending expert order, rounding after each add (the
    reference's sequential scatter), bit for bit. Integer inputs and
    weights and an identity down-projection make every expert output
    exact, so only the weighting and the adds round; summed in the reverse
    order the bits move."""
    T, d, E, k = 32, 16, 8, 4
    rng = np.random.default_rng(21)
    x = torch.as_tensor(rng.integers(-1, 2, (T, d))).to(torch.bfloat16)
    p = {"w_router": torch.as_tensor(rng.standard_normal((d, E),
                                                         dtype=np.float32)),
         "w_gate": torch.as_tensor(rng.integers(-2, 3, (E, d, d))).float(),
         "w_up": torch.as_tensor(rng.integers(-2, 3, (E, d, d))).float(),
         "w_down": torch.eye(d).expand(E, d, d).clone()}
    got, _ = tmoe.moe_ffn(x, p, n_experts=E, top_k=k,
                          capacity_factor=float(E))
    _, top_p, top_e = tmoe._routed(x, p["w_router"], k)
    bf = torch.bfloat16
    xr = x[:, None, None, :]                          # [T, 1, 1, d]
    h = (torch.nn.functional.silu((xr @ p["w_gate"][top_e].to(bf)).float())
         .to(bf) * (xr @ p["w_up"][top_e].to(bf)))[:, :, 0]
    parts = h * top_p.to(bf)[:, :, None]              # [T, k, d]
    order = torch.argsort(top_e, dim=-1)
    parts = torch.take_along_dim(parts, order[:, :, None], dim=1)
    want, rev = parts[:, 0], parts[:, k - 1]
    for j in range(1, k):
        want = want + parts[:, j]
        rev = rev + parts[:, k - 1 - j]
    assert torch.equal(got, want)
    assert not torch.equal(rev, want)
