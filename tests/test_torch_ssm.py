"""The port's SSD scan and Mamba2 mixer against the reference's.

The same numpy-seeded arrays go to the JAX function and to its port:
- the plain scan `ssd_scan_plain` against the Pallas kernel
  `ssd_scan_pallas` in interpret mode and the sequential oracle
  `ref.ssd_scan_ref`, with the reference's kernel-test tolerances
  (`tests/test_kernels.py:64`): 2e-4 for float32 and 5e-2 for bf16;
- `ssd_chunked`, `ssd_decode_step`, `causal_conv1d` and `mamba_mixer`
  against `repro.models.ssm`: 1e-4 in float32 (the same arithmetic summed
  in another order) and, for the bf16 mixer, 2^-5 of the largest value
  (bf16 keeps 8 significant bits, and the frameworks round at the same
  points but sum in different orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.ssm as jssm
import repro_torch.models.ssm as tssm
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels.ssd_scan import (ssd_scan_bytes, ssd_scan_flops,
                                          ssd_scan_plain)

TOL = {"float32": 2e-4, "bfloat16": 5e-2}
F32_TOL = 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _scan_inputs(b, S, H, P, N, dtype, seed):
    """x, dt, A, B, C as in `tests/test_kernels.py::test_ssd_scan_kernel`:
    numpy arrays, x/dt/B/C rounded to ``dtype`` (A stays float32)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P), dtype=np.float32)
    dt = np.abs(rng.standard_normal((b, S, H), dtype=np.float32) * 0.3) + 0.01
    A = (-np.abs(rng.standard_normal(H, dtype=np.float32)) - 0.1)
    B = rng.standard_normal((b, S, N), dtype=np.float32)
    C = rng.standard_normal((b, S, N), dtype=np.float32)
    if dtype == "bfloat16":
        x, dt, B, C = (np.array(jnp.asarray(a, jnp.bfloat16)
                                .astype(jnp.float32)) for a in (x, dt, B, C))
    return x, dt, A, B, C


def _both(arrays, dtypes):
    """(jax arrays, torch tensors) of the same values in the given dtypes."""
    j = tuple(jnp.asarray(a, getattr(jnp, d)) for a, d in zip(arrays, dtypes))
    t = tuple(torch.as_tensor(a).to(getattr(torch, d))
              for a, d in zip(arrays, dtypes))
    return j, t


SHAPES = [
    (2, 64, 3, 4, 8, 16),          # tests/test_kernels.py:51-55
    (1, 40, 2, 8, 4, 16),          # padded chunk tail
    (2, 128, 4, 16, 16, 32),
    (2, 50, 3, 8, 8, 16),          # ragged tail
    (1, 12, 2, 4, 8, 32),          # S < chunk: one chunk of 12
    (1, 160, 24, 64, 128, 128),    # mamba2-130m's head layout, short S
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,S,H,P,N,chunk", SHAPES)
def test_plain_scan_matches_the_pallas_kernel_and_the_oracle(
        b, S, H, P, N, chunk, dtype):
    arrays = _scan_inputs(b, S, H, P, N, dtype, seed=S + H)
    dts = (dtype, dtype, "float32", dtype, dtype)
    (xj, dtj, Aj, Bj, Cj), (xt, dtt, At, Bt, Ct) = _both(arrays, dts)
    y, h = ssd_scan_plain(xt, dtt, At, Bt, Ct, chunk=chunk)
    assert y.dtype == xt.dtype and y.shape == (b, S, H, P)
    assert h.dtype == torch.float32 and h.shape == (b, H, N, P)
    tol = TOL[dtype]
    pallas = ssd_scan_pallas(xj, dtj, Aj, Bj, Cj, chunk=chunk, interpret=True)
    oracle = jref.ssd_scan_ref(xj, dtj, Aj, Bj, Cj)
    np.testing.assert_allclose(_np(y), _np(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(y), _np(oracle), atol=tol, rtol=tol)
    # the port's own oracle is the reference's
    np.testing.assert_allclose(_np(tref.ssd_scan_ref(xt, dtt, At, Bt, Ct)),
                               _np(oracle), atol=tol, rtol=tol)


def _chunk_parallel_scan(x, dt, A, B, C, *, chunk):
    """The CUDA kernels' schedule (`csrc/ssd_scan.cu`) in plain torch,
    with `ssd_scan_plain`'s operations: every chunk's state
    increment and decay first, then the state passing, then every chunk's y
    from the state entering it."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    x, B, C = (torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
               for t in (x, B, C))
    dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    nc = (S + pad) // Q
    xc = x.reshape(b, nc, Q, H, P)
    dtc = dt.reshape(b, nc, Q, H).float()
    Bc = B.reshape(b, nc, Q, N).float()
    Cc = C.reshape(b, nc, Q, N).float()
    cum = torch.cumsum(dtc * A.float(), dim=2)
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    incs, decays = [], []
    for c in range(nc):
        cumq = cum[:, c]
        last = cumq[:, -1, :]
        to_end = torch.exp(last[:, None, :] - cumq) * dtc[:, c]
        incs.append(torch.einsum("bkh,bkn,bkhp->bhnp", to_end, Bc[:, c],
                                 xc[:, c].float()))
        decays.append(torch.exp(last)[:, :, None, None])
    h = torch.zeros(b, H, N, P, dtype=torch.float32)
    entering = []
    for c in range(nc):
        entering.append(h)
        h = h * decays[c] + incs[c]
    ys = []
    for c in range(nc):
        xq, dtq, bq, cq, cumq = (xc[:, c].float(), dtc[:, c], Bc[:, c],
                                 Cc[:, c], cum[:, c])
        scores = torch.einsum("bqn,bkn->bqk", cq, bq)
        decay = cumq[:, :, None, :] - cumq[:, None, :, :]
        decay = torch.where(causal[None, :, :, None], decay, -1e30)
        M = scores[..., None] * torch.exp(decay) * dtq[:, None, :, :]
        y_intra = torch.einsum("bqkh,bkhp->bqhp", M, xq)
        y_inter = (torch.einsum("bqn,bhnp->bqhp", cq, entering[c])
                   * torch.exp(cumq)[..., None])
        ys.append((y_intra + y_inter).to(x.dtype))
    return torch.stack(ys, dim=1).reshape(b, nc * Q, H, P)[:, :S], h


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,S,H,P,N,chunk", SHAPES)
def test_chunk_parallel_schedule_equals_the_plain_scan_and_the_reference(
        b, S, H, P, N, chunk, dtype):
    """The CUDA kernels' decomposition (all chunk states, then the
    state passing, then each chunk's y) is the plain scan's arithmetic:
    bit for bit, since every element sees the same operations in the same
    order; and it matches the Pallas kernel and the oracle."""
    arrays = _scan_inputs(b, S, H, P, N, dtype, seed=S + H + 1)
    dts = (dtype, dtype, "float32", dtype, dtype)
    (xj, dtj, Aj, Bj, Cj), (xt, dtt, At, Bt, Ct) = _both(arrays, dts)
    y, h = _chunk_parallel_scan(xt, dtt, At, Bt, Ct, chunk=chunk)
    want_y, want_h = ssd_scan_plain(xt, dtt, At, Bt, Ct, chunk=chunk)
    assert y.dtype == want_y.dtype and torch.equal(y, want_y)
    assert torch.equal(h, want_h)
    tol = TOL[dtype]
    pallas = ssd_scan_pallas(xj, dtj, Aj, Bj, Cj, chunk=chunk, interpret=True)
    oracle = jref.ssd_scan_ref(xj, dtj, Aj, Bj, Cj)
    np.testing.assert_allclose(_np(y), _np(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(y), _np(oracle), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk", [(32, 8), (48, 16), (40, 64), (130, 128)])
def test_ssd_chunked_matches_the_references_y_and_state(S, chunk, dtype):
    """The model's scan (the port's core through `ops.ssd_scan` + the D
    skip) against the reference's jnp `ssd_chunked`, y and h_final, with
    dt and A float32 as the mixer gives them."""
    b, H, P, N = 2, 3, 4, 8
    arrays = _scan_inputs(b, S, H, P, N, dtype, seed=S)
    D = np.random.default_rng(S + 1).standard_normal(H, dtype=np.float32)
    dts = (dtype, "float32", "float32", dtype, dtype, "float32")
    (xj, dtj, Aj, Bj, Cj, Dj), (xt, dtt, At, Bt, Ct, Dt) = _both(
        arrays + (D,), dts)
    yj, hj = jssm.ssd_chunked(xj, dtj, Aj, Bj, Cj, Dj, chunk=chunk)
    yt, ht = tssm.ssd_chunked(xt, dtt, At, Bt, Ct, Dt, chunk=chunk)
    assert yt.dtype == xt.dtype
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(yt), _np(yj), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(ht), _np(hj), atol=TOL["float32"],
                               rtol=TOL["float32"])


def test_ssd_decode_step_matches_the_reference_and_continues_prefill():
    b, S, H, P, N = 2, 24, 3, 4, 8
    x, dt, A, B, C = _scan_inputs(b, S + 1, H, P, N, "float32", seed=7)
    D = np.random.default_rng(8).standard_normal(H, dtype=np.float32)
    f32 = ("float32",) * 6
    (xj, dtj, Aj, Bj, Cj, Dj), (xt, dtt, At, Bt, Ct, Dt) = _both(
        (x, dt, A, B, C, D), f32)
    _, h0 = tssm.ssd_chunked(xt[:, :S], dtt[:, :S], At, Bt[:, :S], Ct[:, :S],
                             Dt, chunk=8)
    yj, hj = jssm.ssd_decode_step(jnp.asarray(h0.numpy()), xj[:, S], dtj[:, S],
                                  Aj, Bj[:, S], Cj[:, S], Dj)
    yt, ht = tssm.ssd_decode_step(h0, xt[:, S], dtt[:, S], At, Bt[:, S],
                                  Ct[:, S], Dt)
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(_np(ht), _np(hj), rtol=0, atol=F32_TOL)
    y_full, _ = tssm.ssd_chunked(xt, dtt, At, Bt, Ct, Dt, chunk=8)
    np.testing.assert_allclose(_np(yt), _np(y_full[:, S]), rtol=0,
                               atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("streaming", [False, True])
def test_causal_conv1d_matches_the_reference(dtype, streaming):
    rng = np.random.default_rng(3)
    b, S, Ch, W = 2, 1 if streaming else 16, 6, 4
    x = rng.standard_normal((b, S, Ch), dtype=np.float32)
    w = rng.standard_normal((W, Ch), dtype=np.float32) * 0.5
    cache = rng.standard_normal((b, W - 1, Ch), dtype=np.float32)
    (xj, wj, cj), (xt, wt, ct) = _both((x, w, cache),
                                       (dtype, "float32", dtype))
    yj, nj = jssm.causal_conv1d(xj, wj, cj if streaming else None)
    yt, nt = tssm.causal_conv1d(xt, wt, ct if streaming else None)
    assert yt.dtype == xt.dtype
    # the same products summed in the same order in the same dtype
    np.testing.assert_array_equal(_np(yt), _np(yj))
    if streaming:
        np.testing.assert_array_equal(_np(nt), _np(nj))
    else:
        assert nt is None and nj is None


def _mixer_params(d, expand, headdim, n_state, W, seed):
    rng = np.random.default_rng(seed)
    shapes = tssm.mamba_param_shapes(d, expand=expand, headdim=headdim,
                                     n_state=n_state, conv_width=W)
    assert shapes == jssm.mamba_param_shapes(
        d, expand=expand, headdim=headdim, n_state=n_state, conv_width=W)
    p = {}
    for name, shape in shapes.items():
        a = rng.standard_normal(shape, dtype=np.float32)
        if len(shape) == 2:
            a /= np.sqrt(shape[0])
        p[name] = a
    p["A_log"] = np.log(np.linspace(1.0, 16.0, shapes["A_log"][0],
                                    dtype=np.float32))
    p["out_norm"] = np.ones(shapes["out_norm"], np.float32)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.as_tensor(v) for k, v in p.items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_mixer_matches_the_reference_with_and_without_a_cache(dtype):
    d, expand, headdim, N, W, chunk = 32, 2, 8, 16, 4, 8
    pj, pt = _mixer_params(d, expand, headdim, N, W, seed=11)
    x = np.random.default_rng(12).standard_normal((2, 21, d), dtype=np.float32)
    (xj,), (xt,) = _both((x,), (dtype,))
    kw = dict(expand=expand, headdim=headdim, n_state=N, chunk=chunk)

    def close(got, want):
        tol = F32_TOL if dtype == "float32" else \
            float(np.abs(_np(want)).max()) * 2 ** -5
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)

    # prefill over the first 20 tokens, building the decode cache
    yj, cj = jssm.mamba_mixer(xj[:, :20], pj, return_cache=True, **kw)
    yt, ct = tssm.mamba_mixer(xt[:, :20], pt, return_cache=True, **kw)
    assert yt.dtype == xt.dtype and yt.shape == (2, 20, d)
    close(yt, yj)
    close(ct["h"], cj["h"])
    close(ct["conv"], cj["conv"])
    # no cache asked: none built
    assert tssm.mamba_mixer(xt[:, :5], pt, **kw)[1] is None
    # one decode step from the reference's cache
    cache_t = {"h": torch.as_tensor(np.array(cj["h"])),
               "conv": torch.tensor(_np(cj["conv"])).to(xt.dtype)}
    yj1, nj = jssm.mamba_mixer(xj[:, 20:], pj, cache=cj, **kw)
    yt1, nt = tssm.mamba_mixer(xt[:, 20:], pt, cache=cache_t, **kw)
    close(yt1, yj1)
    close(nt["h"], nj["h"])
    close(nt["conv"], nj["conv"])


def test_cpu_tensors_count_no_launch_and_the_launcher_refuses_them():
    arrays = _scan_inputs(1, 20, 2, 4, 8, "float32", seed=0)
    x, dt, A, B, C = (torch.as_tensor(a) for a in arrays)
    before = ssd_mod.launches
    y, h = ops.ssd_scan(x, dt, A, B, C, chunk=8)
    y2, h2 = ssd_mod.ssd_scan(x, dt, A, B, C, chunk=8)
    assert ssd_mod.launches == before
    want, want_h = ssd_scan_plain(x, dt, A, B, C, chunk=8)
    assert torch.equal(y, want) and torch.equal(h, want_h)
    assert torch.equal(y2, want) and torch.equal(h2, want_h)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_mod.ssd_scan_cuda(x, dt, A, B, C, chunk=8)
    with pytest.raises(ValueError):
        ssd_mod.ssd_scan(x, dt[:, :5], A, B, C)          # dt does not match
    assert ssd_mod.launches == before


def test_flops_and_bytes_count_the_work_of_the_call():
    # one chunk of 4 rows: 10 causal pairs
    assert ssd_scan_flops(1, 4, 1, 1, 1, chunk=8) == 2 * (10 + 10 + 2 * 4)
    # a ragged tail: chunks of 4 and 2 rows
    assert ssd_scan_flops(2, 6, 3, 5, 7, chunk=4) == 2 * 2 * (
        (10 + 3) * 7 + (10 + 3) * 15 + 2 * 6 * 7 * 15)
    b, S, H, P, N = 2, 4096, 24, 64, 128
    got = ssd_scan_bytes(b, S, H, P, N, x_size=2, bc_size=2, dt_size=4)
    assert got == (2 * b * S * H * P * 2 + b * S * H * 4 + 4 * H
                   + 2 * b * S * N * 2 + 4 * b * H * N * P)
    # x and y 25.2 MB each, B and C 4.2 MB, dt 0.8 MB, h 1.6 MB
    assert 56e6 < got < 57e6
