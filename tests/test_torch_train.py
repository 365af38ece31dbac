"""Training on the port against the reference's, at `smoke_config` size, in
float32 compute (both packages' compute type patched, as
`tests/test_torch_families.py` does): the loss and every gradient leaf
against `jax.value_and_grad` of the reference's `make_loss_fn`, one
`make_train_step` update from a state carried across
(`train_state_from_reference`), ``microbatches=2`` and
``compression="int8"`` against the reference's steps, and the three
``remat`` policies against each other. Also the schedule, the int8 round
trip and the kernels' autograd Functions (C1) on the CPU.

The four dense configurations and mamba2-130m run here; the other five
families in `tests/test_torch_train_families.py`, which imports the
helpers of this file.

Tolerance: every leaf within 1e-4 of that leaf's largest |value| (the
same arithmetic summed in another order). Two exceptions are stated where
they apply: without RoPE a key bias's gradient is 0 in exact arithmetic (a
bias added to every key moves every score of a query's row by the same
amount, which softmax cancels), so both packages give rounding noise
there, held below 1e-6 of the largest gradient; and int8 compression rounds each package's
own float32 gradient, so an element whose two gradients straddle a
rounding boundary quantizes one step apart (counted, at most 1 in 1000).
Moments stored in bf16 (arctic-480b's) may also differ by one bf16
rounding step of each element.

MoE: the reference's top-k experts are replayed in the port
(`_ReplayRouting` of `tests/test_torch_families.py`), and in float32 no
token may need it; MoE runs ``remat="none"`` on both sides here, so that
each forward routes every layer once (the replay is in call order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jl
import repro.models.model as jm
import repro.models.transformer as jtf
import repro.parallel.collectives as jcol
import repro.train.optimizer as jopt
import repro.train.train_step as jts
import repro_torch.kernels.flash_attention as fa
import repro_torch.kernels.ssd_scan as ssd
import repro_torch.models.layers as tl
import repro_torch.models.model as tm
import repro_torch.models.transformer as ttf
from repro.configs import smoke_config as j_smoke_config
from repro_torch.configs import smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.grad import needs_grad
from repro_torch.parallel.collectives import int8_compress_decompress
from repro_torch.train.optimizer import cosine_lr, tree_leaves
from repro_torch.train.train_step import make_train_step
from test_torch_families import _ReplayRouting

CONFIGS = ["tinyllama-1.1b", "granite-20b", "chatglm3-6b", "qwen2-7b",
           "mamba2-130m"]
TOL = 1e-4
FLIP_FRACTION = 1e-3
ZERO = 1e-6
B, S = 2, 24


@pytest.fixture(scope="module", autouse=True)
def f32_compute():
    """Both packages compute in float32 for the whole module (the jitted
    reference functions read the compute type when they are traced)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jl, jm, jtf):
            mp.setattr(mod, "CDT", jnp.float32)
        for mod in (tl, tm):
            mp.setattr(mod, "CDT", torch.float32)
        yield


def configs(name):
    """(reference config, port config): MoE without remat (see the
    module's docstring)."""
    cfg_j, cfg_t = j_smoke_config(name), smoke_config(name)
    if cfg_t.family == "moe":
        cfg_j = dataclasses.replace(cfg_j, remat="none")
        cfg_t = dataclasses.replace(cfg_t, remat="none")
    return cfg_j, cfg_t


def batches(cfg, seed=0):
    """Seeded tokens [B, S] (+ the frontend's frames or patches)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    bj, bt = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.as_tensor(
        tokens)}
    if cfg.frontend:
        key = "src" if cfg.enc_dec else "frontend"
        emb = rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model),
                                  dtype=np.float32)
        bj[key], bt[key] = jnp.asarray(emb), torch.as_tensor(emb)
    return bj, bt


class Setup:
    """One configuration: both configs, the reference's parameters and
    their port, and a batch for each package."""

    def __init__(self, name):
        self.name = name
        self.cfg_j, self.cfg_t = configs(name)
        self.pj = jm.init_params(self.cfg_j, jax.random.PRNGKey(0))
        self.tree = jax.tree.map(np.asarray, self.pj)
        self.pt = tm.params_from_reference(self.tree, device="cpu")
        self.bj, self.bt = batches(self.cfg_j)
        self.moe = self.cfg_t.family == "moe"

    def routing(self, monkeypatch):
        return _ReplayRouting(monkeypatch) if self.moe else None


@pytest.fixture(scope="module", params=CONFIGS)
def cfg(request):
    return Setup(request.param)


def leaves_by_path(tree) -> dict:
    """{"a/b/c": numpy array} of a nested dict of arrays or tensors."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            out["/".join(path)] = (t.detach().float().numpy()
                                   if isinstance(t, torch.Tensor)
                                   else np.asarray(t, np.float32))

    walk(tree, ())
    return out


def assert_trees_close(got, want, what: str, skip=None) -> None:
    """Every leaf of ``got`` within TOL of the largest |value| of the same
    leaf of ``want``. A leaf whose reference values all lie below ZERO
    times the tree's largest (the gradient of a key bias without RoPE, 0
    in exact arithmetic, and the moments it feeds) must lie below that on
    both sides. ``skip``: {path: bool mask} of elements left out."""
    g, w = leaves_by_path(got), leaves_by_path(want)
    assert g.keys() == w.keys(), what
    top = max(float(np.abs(a).max()) for a in w.values())
    for path, a in w.items():
        b = g[path]
        assert b.shape == a.shape, f"{what} {path}"
        keep = ~skip[path] if skip else np.ones(a.shape, bool)
        if not keep.any():
            continue
        if np.abs(a).max() <= ZERO * top:
            for x in (a, b):
                assert float(np.abs(x).max()) <= ZERO * top, f"{what} {path}"
            continue
        err = np.abs(a - b) - TOL * float(np.abs(a).max()) - bf16_step(
            got, path, a, b)
        assert float(err[keep].max()) <= 0, f"{what} {path}: {err.max()}"


def is_bf16(tree, path: str) -> bool:
    node = tree
    for k in path.split("/"):
        node = node[k]
    return isinstance(node, torch.Tensor) and node.dtype == torch.bfloat16


def bf16_step(tree, path: str, want: np.ndarray, got: np.ndarray):
    """One bf16 rounding step of each element (2^-7 of the larger of the
    two values) where the leaf is stored in bf16 (arctic-480b's moments):
    two float32 values within TOL of each other round to neighbouring bf16
    values when a rounding boundary lies between them. 0 for other
    leaves."""
    if not is_bf16(tree, path):
        return 0.0
    return np.maximum(np.abs(want), np.abs(got)) * 2.0 ** -7


def port_loss_and_grads(c: Setup, cfg_t=None):
    """The port's loss, metrics and gradients (a tree like the params) at
    ``c``'s parameters and batch, under ``cfg_t`` (default: ``c``'s)."""
    leaves = jax.tree.map(lambda t: t.detach().clone().requires_grad_(True),
                          c.pt)
    loss, metrics = tm.make_loss_fn(cfg_t or c.cfg_t)(leaves, c.bt)
    flat = tree_leaves(leaves)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(flat, grads))
    return loss.detach(), metrics, jax.tree.map(lambda _: next(it), c.pt)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------
def check_loss_and_grads(c: Setup, monkeypatch) -> None:
    routing = c.routing(monkeypatch)
    fn = jax.jit(jax.value_and_grad(jm.make_loss_fn(c.cfg_j), has_aux=True))
    (loss_j, metrics_j), grads_j = fn(c.pj, c.bj)
    if routing is not None:
        jax.effects_barrier()
        assert len(routing.picked) == c.cfg_t.n_layers
    loss_t, metrics_t, grads_t = port_loss_and_grads(c)
    if routing is not None:
        assert routing.picked == [] and routing.flips == 0
    assert abs(float(loss_t) - float(loss_j)) <= TOL * abs(float(loss_j))
    assert metrics_t["ntokens"] == metrics_j["ntokens"] == B * (S - 1)
    assert abs(float(metrics_t["aux_loss"]) - float(metrics_j["aux_loss"])) \
        <= TOL * max(abs(float(metrics_j["aux_loss"])), 1e-30)
    if c.moe:
        assert float(metrics_j["aux_loss"]) > 0
    assert_trees_close(grads_t, grads_j, "gradient")


def test_loss_and_grads_match_the_reference(cfg, monkeypatch):
    check_loss_and_grads(cfg, monkeypatch)


# ---------------------------------------------------------------------------
# one train step from a state carried across
# ---------------------------------------------------------------------------
def reference_state(c: Setup, step: int, moments: bool):
    """The reference's `TrainState` at ``step``: its parameters, and
    seeded moments (m ~ N(0, 1e-2), v ~ |N(0, 1e-3)|) or zeros."""
    rng = np.random.default_rng(5)
    st = jts.make_train_state(c.cfg_j, jax.random.PRNGKey(0))
    dt = jax.tree_util.tree_leaves(st.opt.m)[0].dtype

    def draw(p, scale, absolute):
        if not moments:
            return jnp.zeros(p.shape, dt)
        x = rng.standard_normal(p.shape).astype(np.float32) * scale
        return jnp.asarray(np.abs(x) if absolute else x, dt)

    m = jax.tree.map(lambda p: draw(p, 1e-2, False), st.params)
    v = jax.tree.map(lambda p: draw(p, 1e-3, True), st.params)
    return jts.TrainState(params=c.pj, opt=jopt.AdamWState(
        step=jnp.int32(step), m=m, v=v))


def run_both(c: Setup, state_j, monkeypatch, **kw):
    """One step of the reference's (jitted) and the port's train step from
    the same state: (reference state, metrics), (port state, metrics)."""
    routing = c.routing(monkeypatch)
    ref_state = jax.tree.map(np.asarray, state_j)
    new_j, mj = jax.jit(jts.make_train_step(c.cfg_j, **kw))(state_j, c.bj)
    if routing is not None:
        jax.effects_barrier()
    state_t = tm.train_state_from_reference(ref_state, device="cpu")
    new_t, mt = make_train_step(c.cfg_t, **kw)(state_t, c.bt)
    if routing is not None:
        assert routing.picked == [] and routing.flips == 0
    return (new_j, mj), (new_t, mt)


def assert_scalars_close(mt, mj) -> None:
    for key in ("loss", "lr", "grad_norm"):
        want = float(mj[key])
        assert abs(float(mt[key]) - want) <= TOL * abs(want), key


def check_train_step(c: Setup, monkeypatch) -> None:
    (new_j, mj), (new_t, mt) = run_both(c, reference_state(c, 150, True),
                                        monkeypatch)
    assert int(new_t.opt.step) == int(new_j.opt.step) == 151
    assert_scalars_close(mt, mj)
    assert float(mj["lr"]) > 0
    for what, got, want in (("params", new_t.params, new_j.params),
                            ("m", new_t.opt.m, new_j.opt.m),
                            ("v", new_t.opt.v, new_j.opt.v)):
        assert_trees_close(got, want, what)
    # the first step: lr 0 at step 0 (warmup), so only the moments move
    (first_j, mj0), (first_t, mt0) = run_both(
        c, reference_state(c, 0, False), monkeypatch)
    assert float(mj0["lr"]) == float(mt0["lr"]) == 0.0
    assert int(first_t.opt.step) == 1
    for path, p in leaves_by_path(first_t.params).items():
        np.testing.assert_array_equal(p, leaves_by_path(c.pt)[path])
    assert_trees_close(first_t.opt.m, first_j.opt.m, "m")


def test_train_step_matches_the_reference(cfg, monkeypatch):
    check_train_step(cfg, monkeypatch)


def check_microbatches(c: Setup, monkeypatch) -> None:
    (new_j, mj), (new_t, mt) = run_both(c, reference_state(c, 150, True),
                                        monkeypatch, microbatches=2)
    assert set(mt) == set(mj) == {"loss", "lr", "grad_norm"}
    assert_scalars_close(mt, mj)
    for what, got, want in (("params", new_t.params, new_j.params),
                            ("m", new_t.opt.m, new_j.opt.m),
                            ("v", new_t.opt.v, new_j.opt.v)):
        assert_trees_close(got, want, what)


def test_microbatches_match_the_reference(cfg, monkeypatch):
    check_microbatches(cfg, monkeypatch)


def check_int8(c: Setup, monkeypatch) -> None:
    """From zero moments at step 150, m = (1 - b1) c q s (c the clip
    factor, q the int8 value, s the leaf's int8 scale), so the largest |m|
    of a leaf is 127 steps of (1 - b1) c s. An element whose two quantized
    gradients differ (a rounding boundary between the two float32
    gradients) differs by one such step in m; those elements are counted
    and left out of the comparison of params and v, and so is a leaf whose
    gradient is 0 in exact arithmetic (its update's sign is noise)."""
    (new_j, mj), (new_t, mt) = run_both(c, reference_state(c, 150, False),
                                        monkeypatch, compression="int8")
    assert_scalars_close(mt, mj)
    m_t, m_j = leaves_by_path(new_t.opt.m), leaves_by_path(new_j.opt.m)
    top = max(float(np.abs(a).max()) for a in m_j.values())
    flipped, n_flipped, n = {}, 0, 0
    for path, a in m_j.items():
        if np.abs(a).max() <= ZERO * top:
            # a zero gradient: each side quantizes its own rounding noise,
            # and Adam turns it into a full step of random sign
            assert np.abs(m_t[path]).max() <= ZERO * top, path
            flipped[path] = np.ones(a.shape, bool)
            continue
        step_m = float(np.abs(a).max()) / 127    # the largest m is 127 steps
        diff = np.abs(m_t[path] - a)
        rounding = bf16_step(new_t.opt.m, path, a, m_t[path])
        flip = diff > TOL * float(np.abs(a).max()) + rounding
        step_m *= 1 + (2.0 ** -7 if is_bf16(new_t.opt.m, path) else 1e-3)
        assert (diff <= step_m + rounding)[flip].all(), path
        flipped[path] = flip
        n_flipped += int(flip.sum())
        n += a.size
    assert n_flipped <= FLIP_FRACTION * n, (n_flipped, n)
    for what, got, want in (("params", new_t.params, new_j.params),
                            ("v", new_t.opt.v, new_j.opt.v)):
        assert_trees_close(got, want, what, skip=flipped)


def test_int8_compression_matches_the_reference(cfg, monkeypatch):
    check_int8(cfg, monkeypatch)


# ---------------------------------------------------------------------------
# activation checkpointing
# ---------------------------------------------------------------------------
def check_remat(c: Setup) -> None:
    """remat "full", "dots" and "none" give the same loss and gradients,
    bit for bit (the counterpart of tests/test_perf_knobs.py:17)."""
    got = {}
    for remat in ("none", "full", "dots"):
        loss, _, grads = port_loss_and_grads(
            c, dataclasses.replace(c.cfg_t, remat=remat))
        got[remat] = (loss, leaves_by_path(grads))
    for remat in ("full", "dots"):
        assert torch.equal(got[remat][0], got["none"][0]), remat
        for path, g in got["none"][1].items():
            np.testing.assert_array_equal(got[remat][1][path], g,
                                          err_msg=f"{remat} {path}")


def test_remat_policies_agree(cfg):
    check_remat(cfg)


def test_remat_checkpoints_only_while_recording(monkeypatch):
    """The blocks run under checkpointing only when autograd records the
    forward: a forward under no_grad, or with no parameter requiring grad
    (prefill, serving), calls no checkpoint."""
    calls = []
    real = ttf.checkpoint

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ttf, "checkpoint", counting)
    c = Setup("tinyllama-1.1b")
    tm.make_prefill(c.cfg_t)(c.pt, c.bt)
    with torch.no_grad():
        port_params = jax.tree.map(lambda t: t.requires_grad_(True),
                                   tm.params_from_reference(c.tree,
                                                            device="cpu"))
        tm.make_prefill(c.cfg_t)(port_params, c.bt)
    assert calls == []
    port_loss_and_grads(c)
    assert len(calls) == c.cfg_t.n_layers
    with pytest.raises(ValueError):
        bad = dataclasses.replace(c.cfg_t, remat="some")
        tm.make_loss_fn(bad)(port_params, c.bt)


# ---------------------------------------------------------------------------
# schedule and int8
# ---------------------------------------------------------------------------
def test_cosine_lr_matches_the_reference():
    steps = [0, 1, 2, 50, 99, 100, 101, 500, 5000, 9999, 10000, 10001, 20000]
    for peak, warmup, total, frac in ((3e-4, 100, 10000, 0.1),
                                      (1e-3, 0, 1000, 0.0),
                                      (2e-4, 10, 10, 0.25)):
        want = [float(jopt.cosine_lr(jnp.int32(s), peak=peak, warmup=warmup,
                                     total=total, floor_frac=frac))
                for s in steps]
        got = cosine_lr(torch.tensor(steps, dtype=torch.int32), peak=peak,
                        warmup=warmup, total=total, floor_frac=frac)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert float(cosine_lr(torch.tensor(0), peak=3e-4, warmup=100,
                           total=10000)) == 0.0


@pytest.mark.parametrize("shape,scale", [((1000,), 1.0), ((64, 48), 1e-3),
                                         ((7, 5, 3), 37.0), ((3,), 0.0)])
def test_int8_round_trip_is_the_references_bit_for_bit(shape, scale):
    x = (np.random.default_rng(3).standard_normal(shape) * scale).astype(
        np.float32)
    # exact half-way points between quantization steps round to even
    if x.size > 8:
        s = np.float32(np.abs(x).max()) / np.float32(127.0)
        x.flat[:4] = np.array([0.5, 1.5, 2.5, -2.5], np.float32) * s
    want = np.asarray(jcol.int8_compress_decompress(jnp.asarray(x)))
    got = int8_compress_decompress(torch.as_tensor(x)).numpy()
    assert got.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    q_j, s_j = jcol.int8_quantize(jnp.asarray(x))
    from repro_torch.parallel.collectives import int8_quantize
    q_t, s_t = int8_quantize(torch.as_tensor(x))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    assert np.float32(s_t).tobytes() == np.float32(s_j).tobytes()


# ---------------------------------------------------------------------------
# C1: the kernels under autograd, on the CPU
# ---------------------------------------------------------------------------
def kernel_stand_in(plain):
    """A CPU stand-in for a CUDA wrapper: the plain version's values with
    no graph, as a ctypes launch into a fresh buffer gives."""
    def run(*args, **kw):
        with torch.no_grad():
            return plain(*args, **kw)
    return run


@pytest.fixture
def cpu_kernels(monkeypatch):
    monkeypatch.setattr(fa, "flash_attention_cuda",
                        kernel_stand_in(fa.flash_attention_plain))
    monkeypatch.setattr(ssd, "ssd_scan_cuda",
                        kernel_stand_in(ssd.ssd_scan_plain))


def _randn(gen, *shape, dtype=torch.float32, grad=True):
    return torch.randn(*shape, generator=gen).to(dtype).requires_grad_(grad)


@pytest.mark.parametrize("B_,S_,Sk,Hq,Hk,D,causal,window,q_offset,dtype", [
    (2, 33, 33, 4, 2, 16, True, None, 0, torch.float32),
    (1, 20, 20, 6, 2, 8, True, 7, 0, torch.float32),
    (2, 9, 40, 4, 4, 16, False, None, 31, torch.float32),
    (1, 17, 17, 8, 2, 64, True, None, 0, torch.bfloat16),
])
def test_flash_attention_function_backward_is_plain_autograd(
        cpu_kernels, B_, S_, Sk, Hq, Hk, D, causal, window, q_offset, dtype):
    gen = torch.Generator().manual_seed(0)
    q = _randn(gen, B_, S_, Hq, D, dtype=dtype)
    k = _randn(gen, B_, Sk, Hk, D, dtype=dtype)
    v = _randn(gen, B_, Sk, Hk, D, dtype=dtype, grad=dtype == torch.float32)
    w = torch.randn(B_, S_, Hq, D, generator=gen).to(dtype)
    masks = dict(causal=causal, window=window, q_offset=q_offset)
    inputs = [t for t in (q, k, v) if t.requires_grad]
    out = fa.flash_attention_autograd(q, k, v, **masks)
    got = torch.autograd.grad((out.float() * w.float()).sum(), inputs)
    plain = fa.flash_attention_plain(q, k, v, **masks)
    want = torch.autograd.grad((plain.float() * w.float()).sum(), inputs)
    assert torch.equal(out, plain)
    for g, x in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, x)


@pytest.mark.parametrize("b,S_,H,P,N,chunk,dtype,use_h", [
    (2, 40, 3, 4, 5, 16, torch.float32, False),
    (1, 64, 2, 8, 4, 16, torch.float32, True),
    (2, 33, 4, 16, 16, 32, torch.bfloat16, True),
])
def test_ssd_scan_function_backward_is_plain_autograd(
        cpu_kernels, b, S_, H, P, N, chunk, dtype, use_h):
    gen = torch.Generator().manual_seed(1)
    x = _randn(gen, b, S_, H, P, dtype=dtype)
    dt = torch.rand(b, S_, H, generator=gen).requires_grad_()
    A = (-torch.rand(H, generator=gen)).requires_grad_()
    Bm = _randn(gen, b, S_, N, dtype=dtype)
    Cm = _randn(gen, b, S_, N, dtype=dtype)
    inputs = [x, dt, A, Bm, Cm]

    def loss(y, h):
        out = (y.float() ** 2).sum()
        return out + (h ** 2).sum() if use_h else out

    got = torch.autograd.grad(loss(*ssd.ssd_scan_autograd(
        *inputs, chunk=chunk)), inputs)
    want = torch.autograd.grad(loss(*ssd.ssd_scan_plain(
        *inputs, chunk=chunk)), inputs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_wrappers_take_the_function_only_when_recording(monkeypatch):
    """On CUDA tensors the wrappers launch the kernel directly unless the
    call needs gradients; which one they take is read off here by stubbing
    both routes and calling with tensors that claim to be on the card."""
    seen = []
    monkeypatch.setattr(fa, "flash_attention_cuda",
                        lambda *a, **kw: seen.append("direct"))
    monkeypatch.setattr(fa, "flash_attention_autograd",
                        lambda *a, **kw: seen.append("function"))

    class Card(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    def card(t):
        return t.as_subclass(Card)

    q = card(torch.randn(1, 4, 2, 8))
    k = card(torch.randn(1, 4, 2, 8))
    v = card(torch.randn(1, 4, 2, 8))
    fa.flash_attention(q, k, v)
    qg = card(torch.randn(1, 4, 2, 8).requires_grad_())
    fa.flash_attention(qg, k, v)
    with torch.no_grad():
        fa.flash_attention(qg, k, v)
    assert seen == ["direct", "function", "direct"]
    assert needs_grad(qg) and not needs_grad(q, k)


def test_model_gradients_reach_attention_only_through_the_function(
        cpu_kernels, monkeypatch):
    """C1 at the model level: with the attention forced down a kernel-like
    path (values without a graph), wq gets no gradient -- the fault; through
    `flash_attention_autograd` it gets the plain path's, exactly."""
    c = Setup("tinyllama-1.1b")
    _, _, want = port_loss_and_grads(c)
    want = leaves_by_path(want)

    monkeypatch.setattr(ops, "attention", fa.flash_attention_cuda)
    leaves = jax.tree.map(lambda t: t.detach().clone().requires_grad_(True),
                          c.pt)
    loss, _ = tm.make_loss_fn(c.cfg_t)(leaves, c.bt)
    loss.backward()
    assert leaves["layers"]["attn"]["wq"].grad is None

    monkeypatch.setattr(ops, "attention", fa.flash_attention_autograd)
    _, _, got = port_loss_and_grads(c)
    got = leaves_by_path(got)
    wq = got["layers/attn/wq"]
    assert all(bool(np.any(wq[i] != 0)) for i in range(c.cfg_t.n_layers))
    for path, g in want.items():
        np.testing.assert_array_equal(got[path], g, err_msg=path)
