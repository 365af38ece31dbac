"""The reference against the system on the CPU at a tiny size, the control
(the reference in float32) and the faults planted under a run: each must
turn `correct` false."""
import numpy as np
import pytest

from bench_tiny import run_tiny, tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["r3-ycsb-1m", "r3-crash-recovery",
                                  "g64-multikey"])
def test_control_in_float32_is_not_correct(root, cell):
    import control

    got = control.control(root, cell, seed=3, chunks=6)
    assert got["requests"] > 0
    assert got["correct"] is False
    assert got["checks"]["log_rows_differing"] > 0
    if cell.startswith("r3-"):
        # the tails as the window left them are not empty at this size
        assert got["checks"]["spec_rows_differing"] > 0
    if cell == "r3-crash-recovery":
        assert got["view_changes"] >= 2
    if cell == "g64-multikey":
        assert got["cross_group_ops"] > 0


def test_reference_agrees_with_itself_across_replays(root):
    import control

    from harness import compare
    from harness.plan import Plan
    from harness.spec import Spec
    from reference import Deployment

    spec = Spec(root)
    conf = spec.config("nezha-r3")
    tr = spec.traffic("r3-crash-recovery")
    log = control.calls(Plan(tr, conf, 4), 6, tr["drain_s"])
    a, b = Deployment(conf, tr["clients"], 4), Deployment(conf, tr["clients"], 4)
    a.replay(log)
    b.replay(log)
    numbers = compare.compare(a.observation(), b.observation())
    assert compare.verdict(numbers), numbers


def _no_progress(self, duration):
    """run_for that leaves the cluster's state as it was."""


def _half_batch(orig):
    def pop_due(self, horizon):
        due = orig(self, horizon)
        return due[: (due.size + 1) // 2]
    return pop_due


def _altered_answer(orig):
    def run(self, s, eng):
        orig(self, s, eng)
        if s.commit_at_client.size:
            s.commit_at_client = s.commit_at_client.copy()
            s.commit_at_client[0] += 1e-9
    return run


@pytest.mark.parametrize("fault", ["unchanged-state", "half-batch",
                                   "altered-answer"])
@pytest.mark.parametrize("cell", ["r3-ycsb-1m", "g64-ycsb-load"])
def test_planted_fault_turns_correct_false(root, monkeypatch, fault, cell):
    from repro_torch.core import engine, sharded, vectorized_cluster

    if fault == "unchanged-state":
        monkeypatch.setattr(vectorized_cluster.VectorizedNezhaCluster,
                            "run_for", _no_progress)
        monkeypatch.setattr(sharded.ShardedNezhaCluster, "run_for",
                            _no_progress)
    elif fault == "half-batch":
        monkeypatch.setattr(engine.PendingBuffer, "pop_due",
                            _half_batch(engine.PendingBuffer.pop_due))
    else:
        monkeypatch.setattr(engine.DeliverStage, "run",
                            _altered_answer(engine.DeliverStage.run))
    result, _, _ = run_tiny(root, cell, seconds=0.1)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def _follower_admission_flipped(orig):
    """The last follower's admission of every entry of an epoch turned
    over where the replica logs take it, after the commits are decided."""
    def observe_epoch(self, s, *args, **kw):
        adm = np.asarray(s.admitted, bool).copy()
        adm[:, -1] = ~adm[:, -1]
        s.admitted = adm
        return orig(self, s, *args, **kw)
    return observe_epoch


def test_wrong_follower_admission_shows_in_the_speculative_tails(
        root, monkeypatch):
    """A follower's admission that changes no commit is caught by the
    tails the window leaves (the drain empties them)."""
    from repro_torch.core import engine

    monkeypatch.setattr(
        engine.ReplicaLogState, "observe_epoch",
        _follower_admission_flipped(engine.ReplicaLogState.observe_epoch))
    result, _, _ = run_tiny(root, "r3-ycsb-1m", seconds=0.3)
    checks = {k: c["value"] for k, c in result["checks"].items()}
    assert result["correct"] is False
    assert checks["spec_rows_differing"] > 0
    assert checks["log_rows_differing"] == checks["commit_rows_differing"] \
        == 0


def test_watermark_admission_by_hand():
    """Three messages at one replica: the second arrives after the third
    (deadline 2.5) was released at 2.5, so its deadline 2.0 is late."""
    from reference.dataplane import watermark_admit

    d = np.array([1.0, 2.0, 2.5])
    a = np.array([[0.5], [2.6], [2.4]])
    assert watermark_admit(d, a)[:, 0].tolist() == [True, False, True]
