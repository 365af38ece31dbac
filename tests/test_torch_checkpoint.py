"""The port's data pipeline, checkpoints and trainer against the
reference's: the synthetic tokens bit for bit at several (seed, step,
shard); checkpoints written by either package load in the other with
equal integrity hashes and leaves (bf16 leaves as the reference writes
them: raw 2-byte words, ``|V2``); corruption detected; `latest_step`
through the replicated metadata log; the `Trainer`'s kill-and-restore
drill equal to an uninterrupted run, bit for bit; and a 6-step `Trainer`
loss trajectory within 1e-4 of the reference's (float32 compute, the
reference's initial state carried across)."""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.ckpt.checkpoint as jck
import repro.launch.train as jtrain
import repro.models.layers as jl
import repro.models.model as jm
import repro.models.transformer as jtf
import repro_torch.ckpt.checkpoint as tck
import repro_torch.models.layers as tl
import repro_torch.models.model as tm
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokenDataset as JDataset
from repro.data.pipeline import make_host_iterator as j_iterator
from repro_torch.ckpt import ReplicatedMetadataLog
from repro_torch.configs import smoke_config
from repro_torch.data import DataConfig, SyntheticTokenDataset
from repro_torch.data import make_host_iterator
from repro_torch.launch.train import Trainer, TrainerConfig, _tree_of_state
from repro_torch.train.optimizer import tree_leaves


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,step,shard,n_shards,batch,seq,doc", [
    (0, 0, 0, 1, 4, 64, 512), (0, 7, 1, 2, 4, 64, 16),
    (3, 100, 3, 4, 8, 33, 8), (11, 12345, 0, 1, 2, 300, 40)])
def test_tokens_are_the_references_bit_for_bit(seed, step, shard, n_shards,
                                               batch, seq, doc):
    kw = dict(vocab=1000, seq_len=seq, global_batch=batch, n_shards=n_shards,
              shard=shard, seed=seed, mean_doc_len=doc)
    got = SyntheticTokenDataset(DataConfig(**kw)).batch_at(step)["tokens"]
    want = JDataset(JDataConfig(**kw)).batch_at(step)["tokens"]
    assert got.dtype == want.dtype == np.int32
    assert got.tobytes() == want.tobytes()
    it_t = make_host_iterator(1000, seq, batch, n_shards=n_shards,
                              shard=shard, seed=seed, start_step=step)
    it_j = j_iterator(1000, seq, batch, n_shards=n_shards, shard=shard,
                      seed=seed, start_step=step)
    for _ in range(2):
        assert next(it_t)["tokens"].tobytes() == \
            next(it_j)["tokens"].tobytes()
    it_doc = make_host_iterator(1000, seq, batch, n_shards=n_shards,
                                shard=shard, seed=seed, start_step=step,
                                mean_doc_len=doc)
    assert next(it_doc)["tokens"].tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------
def _tree(seed=0):
    """A train-state-like tree of numpy arrays: float32 leaves, an int32
    scalar, bf16 moments (ml_dtypes), nested dicts."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    bf = lambda *s: f(*s).astype(ml_dtypes.bfloat16)
    return {"params": {"embed": f(11, 4), "layers": {"wq": f(2, 4, 4),
                                                      "scale": f(2, 4)}},
            "opt": {"step": np.int32(7), "m": {"embed": bf(11, 4)},
                    "v": {"embed": bf(11, 4)}}}


def _as_port(tree):
    """The same tree as the port holds it: tensors, bf16 as torch bf16."""
    if isinstance(tree, dict):
        return {k: _as_port(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.as_tensor(a)


def _leaf_bytes(tree) -> dict:
    out = {}
    for path, x in jck._flatten(tree):
        if isinstance(x, torch.Tensor):
            x = tck.to_numpy(x)
        out["/".join(path)] = (np.asarray(x).shape, np.asarray(x).tobytes())
    return out


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    tree = _tree()
    man_t = tck.save_checkpoint(str(tmp_path), 5, _as_port(tree),
                                metadata={"arch": "x"})
    got, man_j = jck.load_checkpoint(str(tmp_path), 5)
    assert man_j["integrity_hash"] == man_t["integrity_hash"]
    assert man_t["integrity_hash"] == jck._tree_hash(
        list(jck._flatten(tree)))
    assert _leaf_bytes(got) == _leaf_bytes(tree)
    assert man_j["arrays"]["opt__m__embed"]["dtype"] == "bfloat16"
    assert man_j["arrays"]["opt__step"]["shape"] == []


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    tree = _tree(1)
    jtree = jax.tree.map(jnp.asarray, tree)
    man_j = jck.save_checkpoint(str(tmp_path), 9, jtree)
    got, man_t = tck.load_checkpoint(str(tmp_path), 9)
    assert man_t["integrity_hash"] == man_j["integrity_hash"] == \
        tck._tree_hash([(p, tck.to_numpy(x))
                        for p, x in tck._flatten(_as_port(tree))])
    assert _leaf_bytes(got) == _leaf_bytes(tree)
    m = tck.as_tensor(got["opt"]["m"]["embed"], torch.bfloat16, "cpu")
    assert torch.equal(m, _as_port(tree)["opt"]["m"]["embed"])
    assert int(tck.as_tensor(got["opt"]["step"], torch.int32, "cpu")) == 7


def _corrupt(path: str) -> None:
    with open(path, "r+b") as f:
        f.seek(-3, os.SEEK_END)
        byte = f.read(1)
        f.seek(-3, os.SEEK_END)
        f.write(bytes([byte[0] ^ 0xFF]))


def test_corruption_is_detected(tmp_path):
    tck.save_checkpoint(str(tmp_path), 1, _as_port(_tree()))
    tck.load_checkpoint(str(tmp_path), 1)
    _corrupt(str(tmp_path / "step_0000000001" / "params__embed.npy"))
    for load in (tck.load_checkpoint, jck.load_checkpoint):
        with pytest.raises(IOError):
            load(str(tmp_path), 1)
    tree, _ = tck.load_checkpoint(str(tmp_path), 1, verify=False)
    assert tree["params"]["embed"].shape == (11, 4)


def test_latest_step_follows_the_replicated_log(tmp_path):
    log = ReplicatedMetadataLog(seed=3)
    assert tck.latest_step(str(tmp_path), log=log) is None
    for step in (2, 4):
        man = tck.save_checkpoint(str(tmp_path), step, _as_port(_tree()),
                                  log=log)
    # a later checkpoint the log never committed
    tck.save_checkpoint(str(tmp_path), 6, _as_port(_tree()))
    assert tck.latest_step(str(tmp_path), log=log) == 4
    assert tck.latest_step(str(tmp_path)) == 6
    committed = log.latest_committed()
    assert committed["step"] == 4
    assert committed["hash"] == man["integrity_hash"]
    assert committed["path"].endswith("step_0000000004")
    _, man4 = tck.load_checkpoint(str(tmp_path), log=log)
    assert man4["step"] == 4


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
def _tc(tmp_path, **kw):
    base = dict(arch="tinyllama-1.1b", smoke=True, steps=6, batch=2, seq=32,
                ckpt_dir=str(tmp_path), ckpt_every=3, device="cpu")
    base.update(kw)
    return TrainerConfig(**base)


def _state_bytes(state) -> list:
    return [(tuple(t.shape), t.dtype, tck.to_numpy(t).tobytes())
            for t in tree_leaves(_tree_of_state(state))]


@pytest.mark.parametrize("arch,microbatches", [("tinyllama-1.1b", 1),
                                               ("arctic-480b", 2)])
def test_restore_drill_equals_an_uninterrupted_run(tmp_path, arch,
                                                   microbatches):
    """Kill after 3 steps (checkpointed through the log), restore in a new
    Trainer handed the same log, train to 6: every leaf of the state and
    every step's loss equal a run that was never interrupted, bit for bit
    (arctic-480b: bf16 moments)."""
    whole = Trainer(_tc(tmp_path / "a", arch=arch, ckpt_dir=None,
                        use_metadata_log=False, microbatches=microbatches))
    whole.run()

    first = Trainer(_tc(tmp_path / "b", arch=arch, steps=3,
                        microbatches=microbatches))
    first.run()
    again = Trainer(_tc(tmp_path / "b", arch=arch,
                        microbatches=microbatches))
    again.log = first.log
    assert again.maybe_restore() and again.step == 3
    assert _state_bytes(again.state) == _state_bytes(first.state)
    again.run()
    assert again.step == 6
    assert _state_bytes(again.state) == _state_bytes(whole.state)
    losses = [m["loss"] for m in first.metrics_history
              + again.metrics_history]
    assert losses == [m["loss"] for m in whole.metrics_history]
    if arch == "arctic-480b":
        assert again.state.opt.m["embed"].dtype == torch.bfloat16


def test_trainer_data_keeps_its_document_length_across_a_restore(
        tmp_path):
    """`TrainerConfig.mean_doc_len` reaches the trainer's stream, and the
    restore's fast-forward keeps it: after a restore at step 3 the next
    batch is the stream's batch 3."""
    tc = _tc(tmp_path, steps=3, mean_doc_len=16)
    ds = SyntheticTokenDataset(DataConfig(vocab=smoke_config(tc.arch).vocab,
                                          seq_len=tc.seq,
                                          global_batch=tc.batch,
                                          seed=tc.seed, mean_doc_len=16))
    first = Trainer(tc)
    assert next(first.data)["tokens"].tobytes() == \
        ds.batch_at(0)["tokens"].tobytes()
    first.run()
    again = Trainer(tc)
    again.log = first.log
    assert again.maybe_restore() and again.step == 3
    assert next(again.data)["tokens"].tobytes() == \
        ds.batch_at(3)["tokens"].tobytes()


def test_restore_without_a_checkpoint_is_a_no_op(tmp_path):
    t = Trainer(_tc(tmp_path, use_metadata_log=False))
    assert not t.maybe_restore() and t.step == 0
    assert not Trainer(_tc(None, ckpt_dir=None,
                           use_metadata_log=False)).maybe_restore()


def test_trainer_loss_trajectory_matches_the_reference(tmp_path,
                                                       monkeypatch):
    """Six steps of both trainers from the same state (the reference's,
    carried across) in float32 compute: each step's loss and grad norm
    within 1e-4 (relative), and the final parameters within 1e-4 of each
    leaf's largest |value|."""
    for mod in (jl, jm, jtf):
        monkeypatch.setattr(mod, "CDT", jnp.float32)
    for mod in (tl, tm):
        monkeypatch.setattr(mod, "CDT", torch.float32)
    kw = dict(arch="mamba2-130m", smoke=True, steps=6, batch=2, seq=32,
              use_metadata_log=False, microbatches=2)
    ref = jtrain.Trainer(jtrain.TrainerConfig(**kw))
    port = Trainer(TrainerConfig(**kw, device="cpu"))
    port.state = tm.train_state_from_reference(
        jax.tree.map(np.asarray, ref.state), device="cpu")
    hist_j, hist_t = ref.run(), port.run()
    for mj, mt in zip(hist_j, hist_t):
        for key in ("loss", "grad_norm", "lr"):
            assert abs(mt[key] - mj[key]) <= 1e-4 * abs(mj[key]), key
    assert hist_j[-1]["lr"] > 0
    want = jax.tree_util.tree_leaves_with_path(ref.state.params)
    got = tree_leaves(port.state.params)
    assert len(want) == len(got)
    for (path, a), b in zip(want, got):
        a = np.asarray(a)
        err = np.abs(b.numpy() - a).max()
        assert err <= 1e-4 * np.abs(a).max(), jax.tree_util.keystr(path)


def test_host_metrics_are_pulled_in_one_copy(monkeypatch):
    from repro_torch.launch import train as ttrain

    copies = []
    real = torch.Tensor.cpu

    def counting(self, *a, **kw):
        copies.append(tuple(self.shape))
        return real(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    out = ttrain._host_metrics({"loss": torch.tensor(1.5),
                                "lr": torch.tensor(2.0, dtype=torch.float32),
                                "ntokens": 62})
    assert out == {"loss": 1.5, "lr": 2.0, "ntokens": 62.0}
    assert copies == [(2,)]


def test_cli_defaults_to_the_card_and_runs_on_the_cpu(monkeypatch, capsys):
    from repro_torch.launch import train as ttrain

    monkeypatch.setattr("sys.argv", ["train", "--steps", "1", "--seq", "16",
                                     "--batch", "2", "--no-log"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ttrain.main()
    monkeypatch.setattr("sys.argv", ["train", "--steps", "1", "--seq", "16",
                                     "--batch", "2", "--no-log", "--device",
                                     "cpu", "--arch", "mamba2-130m"])
    ttrain.main()
    assert "step     1 loss" in capsys.readouterr().out
    assert TrainerConfig().device == "cuda"
