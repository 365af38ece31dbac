"""The port's one-shot DOM primitives, commit classification and Fig 1-3
metrics (`repro_torch.core.vectorized`, `repro_torch.core.engine.
classify_commits`) against the reference's, on the CPU (the kernels' plain
versions), bit for bit.

Inputs are made with numpy from a seed: deadlines rounded to a coarse grid
(ties, duplicates), arrivals well past their deadlines (late), dropped
cells (+inf), a replica that receives nothing (dead), and an infinite
reply column. The exact O(N^2) oracle is held against the reference's jit
body under `jax.enable_x64(True)` (its public wrapper imports
`jax.experimental.enable_x64`, which this jax lacks); the legacy chunked
schedule against the reference's watermark schedule on realistic spreads,
where it is exact, and against the reference's own chunked schedule on
adversarial ones, where it is not.
"""
import jax
import jax.experimental
import numpy as np
import pytest

import repro.core.vectorized as RV
from repro.core.engine import classify_commits as ref_classify_commits
from repro.sim.network import CloudNetwork as RefNetwork
from repro.sim.network import NetworkParams as RefNetworkParams
from repro_torch.core import vectorized as PV
from repro_torch.core.engine import classify_commits
from repro_torch.kernels import dom_admit as admit_mod
from repro_torch.kernels import dom_release as release_mod
from repro_torch.sim.network import CloudNetwork, NetworkParams

CPU = dict(device="cpu")


def _batch(seed: int, n: int = 300, R: int = 3, dead: int = None):
    rng = np.random.default_rng(seed)
    send = np.sort(rng.uniform(0, 2e-3, n))
    deadlines = np.round(send + 100e-6, 5)               # ties
    deadlines[rng.random(n) < 0.02] = deadlines[0]        # duplicates
    arrivals = send[:, None] + rng.lognormal(np.log(60e-6), 0.6, (n, R))
    late = rng.random((n, R)) < 0.01
    arrivals[late] += 5e-4                                # far past deadline
    arrivals[rng.random((n, R)) < 0.01] = np.inf          # drops
    if dead is not None:
        arrivals[:, dead] = np.inf                        # a dead replica
    reply = rng.lognormal(np.log(50e-6), 0.5, (n, R))
    mod = rng.lognormal(np.log(40e-6), 0.5, (n, R))
    keys = rng.integers(0, 40, n)
    return deadlines, arrivals, reply, mod, keys


def _same(want, got, where=""):
    want = np.asarray(want)
    assert want.dtype == got.dtype and want.shape == got.shape, where
    assert want.tobytes() == got.tobytes(), where


BATCHES = [(0, None), (1, 2), (2, 0), (3, None)]


@pytest.mark.parametrize("seed,dead", BATCHES)
def test_watermark_schedule_is_the_references(seed, dead):
    d, a, *_ = _batch(seed, dead=dead)
    _same(RV.dom_admit_watermark_np(d, a), PV.dom_admit_watermark_np(d, a,
                                                                     **CPU))
    for w, g in zip(RV.dom_release_schedule_watermark(d, a),
                    PV.dom_release_schedule_watermark(d, a, **CPU)):
        _same(w, g)


def test_empty_and_one_message_schedules():
    for n in (0, 1):
        d, a = np.full(n, 1e-3), np.full((n, 3), 0.5e-3)
        for w, g in zip(RV.dom_release_schedule_watermark(d, a),
                        PV.dom_release_schedule_watermark(d, a, **CPU)):
            _same(w, g, f"n {n}")
        res = PV.nezha_commit_times(d, a, np.full((n, 3), 1e-5), 0, 1, **CPU)
        want = RV.nezha_commit_times(d, a, np.full((n, 3), 1e-5), 0, 1)
        for key in want:
            _same(want[key], res[key], f"n {n} {key}")


@pytest.mark.parametrize("seed,dead", BATCHES)
@pytest.mark.parametrize("with_keys", [False, True])
@pytest.mark.parametrize("with_mod", [False, True])
def test_nezha_commit_times_are_the_references(seed, dead, with_keys,
                                               with_mod):
    d, a, reply, mod, keys = _batch(seed, dead=dead)
    kw = dict(mod_owd=mod if with_mod else None,
              key_ids=keys if with_keys else None)
    want = RV.nezha_commit_times(d, a, reply, 1, 1, **kw)
    got = PV.nezha_commit_times(d, a, reply, 1, 1, **kw, **CPU)
    assert set(got) == set(want) == {"commit_time", "fast", "committed",
                                     "admitted", "release"}
    for key in want:
        _same(want[key], got[key], key)
    # both paths taken: a dead replica leaves no fast quorum at f 1, and
    # key classes keep one request's disagreement from another's prefix
    if dead is not None:
        assert not got["fast"].any()
    elif with_keys:
        assert got["fast"].any()
    assert (~got["fast"] & got["committed"]).any()


@pytest.mark.parametrize("f", [1, 2])
def test_nezha_commit_times_with_an_inf_reply_column(f):
    R = 2 * f + 1
    d, a, reply, _, keys = _batch(7, R=R)
    reply[:, R - 1] = np.inf                   # replies never arrive
    want = RV.nezha_commit_times(d, a, reply, 0, f, key_ids=keys,
                                 leader_batch_delay=30e-6)
    got = PV.nezha_commit_times(d, a, reply, 0, f, key_ids=keys,
                                leader_batch_delay=30e-6, **CPU)
    for key in want:
        _same(want[key], got[key], key)


@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("with_keys", [False, True])
def test_classify_commits_with_a_given_order_and_force_slow(seed, with_keys):
    """A tier's order (deadline-sorted, with the non-admitted rows moved
    to the tail: their place is immaterial) and a capped mask."""
    d, a, reply, mod, keys = _batch(seed, dead=1)
    admitted, release = RV.dom_release_schedule_watermark(d, a)
    order = np.argsort(d, kind="stable")
    nobody = ~admitted.any(axis=1)[order]
    order = np.concatenate([order[~nobody], order[nobody][::-1]])
    force_slow = np.random.default_rng(seed).random(d.size) < 0.2
    kw = dict(mod_owd=mod, leader_batch_delay=20e-6,
              key_ids=keys if with_keys else None, order=order,
              force_slow=force_slow)
    want = ref_classify_commits(d, a, admitted, release, reply, 2, 1, **kw)
    got = classify_commits(d, a, admitted, release, reply, 2, 1, **kw, **CPU)
    for key in want:
        _same(want[key], got[key], key)
    assert not got["fast"][force_slow].any()


@pytest.mark.parametrize("seed,dead", BATCHES)
def test_classify_commits_takes_the_deadline_order_itself(seed, dead):
    """Without ``order``: the stable deadline order of the `dom_release`
    plain version, with a capped mask and the default mod_owd."""
    d, a, reply, _, keys = _batch(seed, dead=dead)
    admitted, release = RV.dom_release_schedule_watermark(d, a)
    force_slow = np.random.default_rng(seed + 9).random(d.size) < 0.2
    kw = dict(key_ids=keys, force_slow=force_slow)
    want = ref_classify_commits(d, a, admitted, release, reply, 0, 1, **kw)
    got = classify_commits(d, a, admitted, release, reply, 0, 1, **kw, **CPU)
    for key in want:
        _same(want[key], got[key], key)


def test_one_shot_primitives_count_no_launch_on_the_cpu():
    d, a, reply, *_ = _batch(5)
    before = (admit_mod.launches, release_mod.launches)
    PV.nezha_commit_times(d, a, reply, 0, 1, **CPU)
    PV.dom_release_schedule_watermark(d, a, **CPU)
    PV.dom_release_schedule(d[:8], a[:8], **CPU)
    assert (admit_mod.launches, release_mod.launches) == before


def test_entry_points_run_on_the_card_unless_asked_for_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    d, a, reply, *_ = _batch(5, n=8)
    for call in (lambda: PV.dom_admit_watermark_np(d, a),
                 lambda: PV.dom_release_schedule_watermark(d, a),
                 lambda: PV.dom_release_schedule(d, a),
                 lambda: PV.nezha_commit_times(d, a, reply, 0, 1),
                 lambda: classify_commits(d, a, a < np.inf, a, reply, 0, 1),
                 lambda: PV.dom_reordering(a[:, :2] - d[:, None], d, d)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# ---------------------------------------------------------------------------
# the exact oracle and the legacy chunked schedule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,n,dead", [(0, 1, None), (1, 7, None),
                                         (2, 33, 1), (3, 64, None),
                                         (4, 64, 0)])
def test_exact_schedule_is_the_references_oracle(seed, n, dead):
    d, a, *_ = _batch(seed, n=n, dead=dead)
    with jax.enable_x64(True):
        want = RV._dom_release_schedule_impl(d, a)
        want = [np.asarray(x) for x in want]
    got = PV.dom_release_schedule(d, a, **CPU)
    for w, g in zip(want, got):
        _same(w, g)
    # and the watermark schedule is exact against it
    for w, g in zip(want, PV.dom_release_schedule_watermark(d, a, **CPU)):
        _same(w, g)


def _realistic(seed: int, n: int = 200):
    """The reference's property-test spread: sends over 1 s, lognormal
    60 us delays -- arrival lateness << a chunk's deadline span."""
    rng = np.random.default_rng(seed)
    send = np.sort(rng.uniform(0, 1.0, n))
    arrivals = send[:, None] + rng.lognormal(np.log(60e-6), 0.6, (n, 3))
    arrivals[rng.random((n, 3)) < 0.05] = np.inf
    return send + 100e-6, arrivals


@pytest.mark.parametrize("chunk", [2, 5, 2048])
def test_chunked_schedule_is_the_references_watermark_when_exact(chunk):
    d, a = _realistic(chunk)
    want = RV.dom_release_schedule_watermark(d, a)
    for w, g in zip(want, PV.dom_release_schedule_chunked(d, a, chunk=chunk,
                                                          **CPU)):
        _same(w, g)


@pytest.fixture
def reference_x64(monkeypatch):
    """Lend the reference's oracle the `jax.experimental.enable_x64` name
    it imports (this jax spells it `jax.enable_x64`)."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


@pytest.mark.parametrize("chunk", [2, 5, 2048])
def test_chunked_schedule_is_the_references_on_dense_batches(reference_x64,
                                                             chunk):
    """Dense batches with ties and late arrivals, where the chunked
    approximation differs from the exact schedule: it still differs as
    the reference's does, carried watermark and all."""
    d, a, *_ = _batch(chunk, n=120, dead=2)
    want = RV.dom_release_schedule_chunked(d, a, chunk=chunk)
    got = PV.dom_release_schedule_chunked(d, a, chunk=chunk, **CPU)
    for w, g in zip(want, got):
        _same(w, g)


# ---------------------------------------------------------------------------
# Figs 1-3 (benchmarks/figs.py:32-89) at n_msgs 2000
# ---------------------------------------------------------------------------
N_MSGS = 2000


def _fig_owd(net_cls, params_cls, n_nodes, net_seed, send_seed, src_seed,
             n_send, dur):
    net = net_cls(n_nodes, params_cls(), seed=net_seed)
    if send_seed == src_seed:               # Fig 3 draws both from one rng
        rng = np.random.default_rng(send_seed)
        sends = np.sort(rng.uniform(0, dur, N_MSGS))
        srcs = rng.integers(0, n_send, N_MSGS) + 2
    else:
        sends = np.sort(np.random.default_rng(send_seed).uniform(0, dur,
                                                                 N_MSGS))
        srcs = np.random.default_rng(src_seed).integers(0, n_send,
                                                         N_MSGS) + 2
    owd, _ = net.sample_owd_matrix(srcs, N_MSGS, [0, 1])
    return owd, sends


FIG_INPUTS = (
    [("fig1", rate, (4, 1, 0, 1, 2, N_MSGS / (2 * rate)))
     for rate in (1e3, 5e3, 20e3)]
    + [("fig2", n, (2 + n, 2, 3, 4, n, N_MSGS / (n * 10_000)))
       for n in (2, 10)]
    + [("fig3", 10, (12, 5, 6, 6, 10, N_MSGS / 100_000))])


@pytest.mark.parametrize("fig,x,args", FIG_INPUTS,
                         ids=[f"{f}-{x:g}" for f, x, _ in FIG_INPUTS])
def test_fig_1_to_3_scores_are_the_references(fig, x, args):
    r_owd, r_sends = _fig_owd(RefNetwork, RefNetworkParams, *args)
    owd, sends = _fig_owd(CloudNetwork, NetworkParams, *args)
    _same(r_owd, owd, "owd")
    assert RV.multicast_reordering(r_owd, r_sends) == \
        PV.multicast_reordering(owd, sends)
    if fig != "fig3":
        return
    for pctl in (50, 75, 90, 95):
        deadlines = sends + (np.percentile(owd, pctl) + 3 * 60e-9)
        want = RV.dom_reordering(r_owd, r_sends, deadlines)
        got = PV.dom_reordering(owd, sends, deadlines, **CPU)
        assert got == want, pctl


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reordering_score_is_the_references(seed):
    rng = np.random.default_rng(seed)
    for ranks in (rng.permutation(500), np.arange(50), np.arange(40)[::-1],
                  rng.integers(0, 20, 300), np.zeros(0, np.int64)):
        assert PV.reordering_score_np(ranks) == RV.reordering_score_np(ranks)


def test_vec_dom_params_are_the_references():
    import dataclasses

    assert dataclasses.asdict(PV.VecDomParams()) == \
        dataclasses.asdict(RV.VecDomParams())
