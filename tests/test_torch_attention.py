"""The port's attention (repro_torch.models.attention, on the CPU: the
flash-attention kernel's plain version) against the reference's jnp
`flash_attention`, its dense oracle and `ref.flash_attention_ref`.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are those of the reference's kernel tests
(tests/test_kernels.py): 2e-5 in float32 (only the summation order
differs) and 2e-2 in bf16 (both round a float32 result to bf16 once; one
unit in the last place of an output below 2 is at most 7.8e-3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (attention_flops,
                                                 kernel_route,
                                                 tensor_map_args)
from repro_torch.models import attention as tattn

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
D = 64


def _inputs(B, S, Sk, Hq, Hk, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((B, S, Hq, D), (B, Sk, Hk, D), (B, Sk, Hk, D))]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 64, 200])
@pytest.mark.parametrize("Hq,Hk", [(4, 4), (4, 2), (8, 1)])
def test_flash_attention_matches_reference(Hq, Hk, S, causal, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(2, S, S, Hq, Hk, dtype,
                                         seed=S * 10 + Hq + Hk)
    got = tattn.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want_ref = jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                        window=window)
    if causal or window is None:
        # the jnp twin's static KV band (n_band chunks from the window's
        # lower edge) assumes causal masking: non-causal with a window it
        # drops the keys above the band, where the Pallas kernel walks to
        # the last KV block and agrees with the dense oracle
        want_flash = jattn.flash_attention(jq, jk, jv, causal=causal,
                                           window=window, chunk_q=64,
                                           chunk_kv=64)
        np.testing.assert_allclose(_np(got), _np(want_flash), rtol=0,
                                   atol=TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(want_ref), rtol=0,
                               atol=TOL[dtype])
    np.testing.assert_allclose(
        _np(tref.flash_attention_ref(tq, tk, tv, causal=causal,
                                     window=window)),
        _np(want_ref), rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,Sk,q_offset,window", [
    (1, 100, 99, None),          # one decode-like query at the end
    (37, 120, 83, None),         # a chunk at the end of a longer context
    (50, 150, 100, 40),
])
def test_flash_attention_q_offset_matches_reference(S, Sk, q_offset, window,
                                                    dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, S, Sk, 8, 2, dtype, seed=Sk)
    got = tattn.flash_attention(tq, tk, tv, causal=True, window=window,
                                q_offset=q_offset)
    want = jattn.reference_attention(jq, jk, jv, causal=True, window=window,
                                     q_offset=q_offset)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL[dtype])
    want_flash = jattn.flash_attention(jq, jk, jv, causal=True, window=window,
                                       q_offset=q_offset)
    np.testing.assert_allclose(_np(got), _np(want_flash), rtol=0,
                               atol=TOL[dtype])


def test_rows_that_see_no_key_come_out_zero():
    """The kernel's rule (p = 0 for masked scores, `_fa_kernel`): a query
    whose window holds no key gives 0, where a softmax oracle would spread
    evenly. The test the reference's dense oracle cannot make."""
    _, (tq, tk, tv) = _inputs(1, 8, 8, 4, 2, "float32", seed=3)
    out = tattn.flash_attention(tq, tk, tv, causal=True, window=2,
                                q_offset=20)
    assert torch.count_nonzero(out) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("Hq,Hk", [(4, 4), (8, 1)])
@pytest.mark.parametrize("per_row", [False, True])
def test_decode_attention_matches_reference(Hq, Hk, window, dtype, per_row):
    rng = np.random.default_rng(Hq * 7 + Hk)
    B, Smax = 3, 48
    q = rng.standard_normal((B, 1, Hq, D), dtype=np.float32)
    kc = rng.standard_normal((B, Smax, Hk, D), dtype=np.float32)
    vc = rng.standard_normal((B, Smax, Hk, D), dtype=np.float32)
    cur = np.array([5, 48, 30], np.int32) if per_row else 29
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jattn.decode_attention(jnp.asarray(q, jd), jnp.asarray(kc, jd),
                                  jnp.asarray(vc, jd), jnp.asarray(cur),
                                  window=window)
    got = tattn.decode_attention(torch.as_tensor(q).to(td),
                                 torch.as_tensor(kc).to(td),
                                 torch.as_tensor(vc).to(td),
                                 torch.as_tensor(cur) if per_row else cur,
                                 window=window)
    assert got.dtype == td
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL[dtype])


def test_attention_flops_counts_the_visible_pairs():
    # causal S = Sk = 4: 1 + 2 + 3 + 4 visible pairs, 4 D FLOPs each
    assert attention_flops(1, 4, 4, 1, 64, causal=True) == 4 * 64 * 10
    assert attention_flops(2, 4, 4, 3, 64, causal=False) == 2 * 3 * 4 * 64 * 16
    # window 2: each query sees itself and one key before it (row 0: one)
    assert attention_flops(1, 4, 4, 1, 64, causal=True, window=2) == \
        4 * 64 * 7
    # the prefill shape of chip_smoke.py: 137.5 GFLOP
    assert attention_flops(2, 4096, 4096, 32, 64, causal=True) == \
        4 * 2 * 32 * 64 * (4096 * 4097 // 2)


@pytest.mark.parametrize("B,S,H,D", [(2, 4096, 4, 64), (1, 65, 5, 128),
                                     (3, 1, 1, 64)])
def test_tensor_map_args_address_every_element(B, S, H, D):
    """The tensor-core kernel's 4-D TMA map (dims D, H, S, B innermost
    first, byte strides of dims 1-3) addresses each element of a contiguous
    [B, S, H, D] bf16 tensor where torch keeps it, its dim 2 ends at S (a
    row past it reads zeros, not the next sequence's), and every stride is
    a multiple of the 16 bytes TMA requires."""
    t = torch.zeros(B, S, H, D, dtype=torch.bfloat16)
    args = tensor_map_args(t)
    dims, strides = args[:4], args[4:]
    assert dims == (D, H, S, B)
    e = t.element_size()
    rng = np.random.default_rng(S)
    for b, s, h, d in zip(rng.integers(0, B, 20), rng.integers(0, S, 20),
                          rng.integers(0, H, 20), rng.integers(0, D, 20)):
        offset = d * e + h * strides[0] + s * strides[1] + b * strides[2]
        want = sum(int(i) * st for i, st in zip((b, s, h, d), t.stride()))
        assert offset == want * e
    assert all(st % 16 == 0 for st in strides)


def test_kernel_route_by_dtype():
    assert kernel_route(torch.bfloat16) == "tensor_core"
    assert kernel_route(torch.float32) == "scalar"
    assert kernel_route(torch.bfloat16, scalar=True) == "scalar"
    assert kernel_route(torch.float32, scalar=True) == "scalar"
