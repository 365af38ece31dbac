"""The port's cost analysis, roofline, reprocessing, dry run and hillclimb
against the reference's, on the CPU.

`repro_torch.analysis.ops` (aten-op listings under `FakeTensorMode`)
against `repro.analysis.hlo` on `tests/test_analysis.py`'s scan program
(gradient with respect to x and the weights, so both sides compute the
same 3L products): the dot FLOPs exactly. `model_flops` on all 40 cells
and `analyze` of one synthetic results file against the reference's, its
constants patched to the H100's, field by field. The dry run at smoke
size on the CPU (nothing timed), its depth probes against a recording at
full depth, the hand-written kernels recorded as one op each, a reprocess
round trip, the cuts out of memory, and the hillclimb's loop on stubbed
cells."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.analysis.roofline as jroof
import repro.parallel.sharding as jsh
from repro.analysis.hlo import analyze_hlo
from repro.configs import get_config as j_get_config
from repro.models.model import abstract_params as j_abstract_params
from repro_torch.analysis import ops as tops
from repro_torch.analysis import reprocess as trep
from repro_torch.analysis import roofline as troof
from repro_torch.configs import all_arch_names, get_config, smoke_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun, hillclimb

CELLS = [(a, s) for a in all_arch_names() for s in SHAPES]
GiB = 2 ** 30


# ---------------------------------------------------------------------------
# the op listing and its analysis
# ---------------------------------------------------------------------------
def test_scan_program_dot_flops_equal_the_hlo_analyzers():
    L, B, D = 4, 16, 32

    def step(x, ws):
        def body(x, w):
            return jnp.tanh(x @ w), None

        y, _ = jax.lax.scan(body, x, ws)
        return y.sum()

    hlo = jax.jit(jax.grad(step, argnums=(0, 1))).lower(
        jax.ShapeDtypeStruct((B, D), jnp.float32),
        jax.ShapeDtypeStruct((L, D, D), jnp.float32)).compile().as_text()

    def tstep(x, ws):
        x, ws = x.requires_grad_(True), ws.requires_grad_(True)
        y = x
        for i in range(L):
            y = torch.tanh(y @ ws[i])
        return torch.autograd.grad(y.sum(), (x, ws))

    listing = tops.record_ops(tstep, torch.empty(B, D, device="meta"),
                              torch.empty(L, D, D, device="meta"))
    got = tops.analyze_ops(listing)
    assert got["dot_flops"] == analyze_hlo(hlo)["dot_flops"] == \
        2 * B * D * D * 3 * L
    assert sum(n for op, n, _, _ in listing if op == "aten.mm.default") \
        == 3 * L
    assert got["collective_total_bytes"] == 0.0


def test_hand_written_all_reduce_counts_both_operands():
    """`tests/test_analysis.py::test_collectives_parse_tuple_shapes` as a
    listing: one c10d all-reduce of f32[8,4] and f32[16]."""
    hlo = """HloModule test, entry_computation_layout={()->f32[]}

ENTRY %main (p: f32[8,4]) -> f32[8,4] {
  %p = f32[8,4]{1,0} parameter(0)
  %ar = (f32[8,4]{1,0}, f32[16]{0}) all-reduce(%p, %p), replica_groups={}, to_apply=%add
  ROOT %gte = f32[8,4]{1,0} get-tuple-element(%ar), index=0
}
"""
    listing = [["c10d.allreduce_.default", 1,
                [["float32", [8, 4]], ["float32", [16]]],
                [["float32", [8, 4]], ["float32", [16]]]]]
    got = tops.collective_bytes_from_ops(listing)
    assert got["bytes"] == {"all-reduce": (8 * 4 + 16) * 4}
    assert got["bytes"]["all-reduce"] == \
        analyze_hlo(hlo)["collective_bytes"]["all-reduce"]
    assert got["counts"] == {"all-reduce": 1.0}
    assert got["total_bytes"] == (8 * 4 + 16) * 4
    assert got["memory_bytes"] == 2 * (8 * 4 + 16) * 4


@pytest.fixture
def one_rank_group(tmp_path):
    import torch.distributed as dist

    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_recorded_collectives_are_counted(one_rank_group):
    from repro_torch.parallel.collectives import compressed_allreduce

    with tops.OpRecorder() as rec:
        compressed_allreduce(torch.randn(5))
    got = tops.analyze_ops(rec.listing())
    # int8 words and one float32 scale a rank, gathered
    assert got["collective_bytes"] == {"all-gather": 5.0 + 4.0}
    assert got["collective_counts"] == {"all-gather": 2.0}


def test_dot_rules_and_movers():
    listing = [
        ["aten.addmm.default", 2, [["float32", [7]], ["bfloat16", [3, 5]],
                                   ["bfloat16", [5, 7]]],
         [["bfloat16", [3, 7]]]],
        ["aten.bmm.default", 1, [["float32", [2, 3, 4]],
                                 ["float32", [2, 4, 6]]],
         [["float32", [2, 3, 6]]]],
        ["aten.mul.Tensor", 9, [["float32", [100]], ["float32", [100]]],
         [["float32", [100]]]],                  # elementwise: not counted
        ["aten.copy_.default", 1, [["float32", [4]], ["float32", [4]]],
         [["float32", [4]]]],
        ["aten.sum.dim_IntList", 1, [["float32", [4, 5]]],
         [["float32", [4]]]]]
    got = tops.analyze_ops(listing)
    assert got["dot_flops"] == 2 * (2 * 3 * 7 * 5) + 2 * 2 * 3 * 6 * 4
    assert got["memory_bytes"] == (
        2 * (3 * 7 * 2 + 3 * 5 * 2 + 5 * 7 * 2)
        + (2 * 3 * 6 + 2 * 3 * 4 + 2 * 4 * 6) * 4 + 16 + 16)


def _qkv(requires_grad=False):
    gen = torch.Generator().manual_seed(0)
    return tuple(torch.randn(shape, generator=gen, dtype=torch.bfloat16)
                 .requires_grad_(requires_grad)
                 for shape in ((2, 64, 4, 16), (2, 64, 2, 16), (2, 64, 2, 16)))


def _kernel_entries(listing, name):
    return [e for e in listing if e[0] == f"kernel.{name}"]


def test_flash_attention_is_recorded_as_one_kernel_op():
    """Under the recorder the wrapper takes its card route: one op with the
    kernel's FLOPs and bytes, and none of the plain version's products."""
    from repro_torch.kernels import flash_attention as fa

    launches = fa.launches
    listing = tops.record_ops(
        lambda q, k, v: fa.flash_attention(q, k, v, causal=True, window=24),
        *_qkv())
    (entry,) = _kernel_entries(listing, "flash_attention")
    assert entry[1] == 1
    assert entry[4] == {
        "flops": fa.attention_flops(2, 64, 64, 4, 16, causal=True, window=24),
        "bytes": 2 * 16 * (2 * 2 * 64 * 4 + 2 * 2 * 64 * 2)}
    assert not any(op.startswith(("aten.bmm", "aten.mm", "aten.matmul"))
                   for op, *_ in listing)
    assert tops.analyze_ops(listing)["dot_flops"] == entry[4]["flops"]
    assert fa.launches == launches                 # nothing was launched


def test_a_kernels_backward_is_recorded_as_the_plain_versions():
    """Training: the forward is the kernel's one op; the backward recomputes
    the plain version and differentiates it, on the card as here."""
    from repro_torch.kernels import flash_attention as fa

    def step(q, k, v):
        q.requires_grad_(True)
        fa.flash_attention(q, k, v, causal=True).float().sum().backward()

    listing = tops.record_ops(step, *_qkv())
    assert len(_kernel_entries(listing, "flash_attention")) == 1
    assert any(op.startswith("aten.bmm") for op, *_ in listing)


def test_ssd_scan_is_recorded_as_one_kernel_op():
    from repro_torch.kernels import ssd_scan as ssd

    gen = torch.Generator().manual_seed(0)
    b, S, H, P, N = 1, 96, 2, 16, 8
    x = torch.randn(b, S, H, P, generator=gen, dtype=torch.bfloat16)
    dt = torch.rand(b, S, H, generator=gen)
    A = -torch.rand(H, generator=gen)
    B, C = (torch.randn(b, S, N, generator=gen, dtype=torch.bfloat16)
            for _ in range(2))
    listing = tops.record_ops(
        lambda *a: ssd.ssd_scan(*a, chunk=32), x, dt, A, B, C)
    (entry,) = _kernel_entries(listing, "ssd_scan")
    assert entry[4] == {
        "flops": ssd.ssd_scan_flops(b, S, H, P, N, 32),
        "bytes": ssd.ssd_scan_bytes(b, S, H, P, N, x_size=2, bc_size=2,
                                    dt_size=4)}
    assert [e[3] for e in listing] == [[["bfloat16", [b, S, H, P]],
                                        ["float32", [b, H, N, P]]]]


def test_listings_round_trip_through_gzip(tmp_path):
    listing = {"probes": [{"depth": {"n_layers": 0}, "weight": -1.0,
                           "ops": [["aten.mm.default", 1,
                                    [["float32", [2, 3]],
                                     ["float32", [3, 4]]],
                                    [["float32", [2, 4]]]]]}]}
    tops.save_listing(tmp_path / "x.ops.json.gz", listing)
    assert tops.load_listing(tmp_path / "x.ops.json.gz") == listing
    assert tops.analyze_ops(listing)["dot_flops"] == -48.0


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_is_the_references(arch, shape):
    assert troof.model_flops(arch, shape) == jroof.model_flops(arch, shape)


def test_model_flops_at_a_batch_and_depth():
    cfg = get_config("tinyllama-1.1b")
    from repro_torch.models.model import count_params

    n3 = count_params(dataclasses.replace(cfg, n_layers=3), active_only=True)
    assert troof.model_flops("tinyllama-1.1b", "train_4k", batch=2,
                             n_layers=3) == 6.0 * n3 * 4096 * 2
    assert troof.model_flops("tinyllama-1.1b", "decode_32k", batch=8) == \
        2.0 * count_params(cfg, active_only=True) * 8


def _synthetic_results() -> list:
    rng = np.random.default_rng(7)
    rows = []
    for arch, shape, mp, status in (
            ("tinyllama-1.1b", "train_4k", False, "ok"),
            ("qwen2-7b", "decode_32k", False, "ok"),
            ("dbrx-132b", "prefill_32k", False, "ok"),
            ("mamba2-130m", "long_500k", False, "ok"),
            ("hymba-1.5b", "train_4k", True, "ok"),
            ("granite-20b", "long_500k", False, "skipped")):
        r = {"arch": arch, "shape": shape, "multi_pod": mp, "status": status}
        if status == "ok":
            r.update(n_chips=512 if mp else 256,
                     flops=float(rng.uniform(1e12, 1e15)),
                     bytes_accessed=float(rng.uniform(1e9, 1e12)),
                     collective_bytes={"total_bytes": float(
                         rng.uniform(0, 1e11))},
                     memory={"argument_size_bytes": int(rng.integers(1e9, 1e10)),
                             "temp_size_bytes": int(rng.integers(1e8, 1e9))})
        rows.append(r)
    return rows


@pytest.mark.parametrize("multi_pod", [False, True, None])
def test_analyze_is_the_references_with_the_h100_constants(
        tmp_path, monkeypatch, multi_pod):
    monkeypatch.setattr(jroof, "PEAK_FLOPS", troof.PEAK_FLOPS)
    monkeypatch.setattr(jroof, "HBM_BW", troof.HBM_BW)
    monkeypatch.setattr(jroof, "ICI_BW", troof.LINK_BW)
    path = tmp_path / "results.json"
    path.write_text(json.dumps(_synthetic_results()))
    want = jroof.analyze(str(path), multi_pod=multi_pod)
    got = troof.analyze(str(path), multi_pod=multi_pod)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            assert getattr(g, f.name) == getattr(w, f.name), f.name
        assert g.step_time() == w.step_time()
        assert g.roofline_fraction() == w.roofline_fraction()
        assert g.measured_fraction() is None
    assert troof.PEAK_FLOPS == 989e12 and troof.HBM_BW == 3.35e12


def test_measured_fraction_and_the_table(tmp_path):
    rows = _synthetic_results()[:2]
    rows[0].update(n_chips=1, batch=16, step_s=2.0, peak_bytes=30 * GiB)
    path = tmp_path / "results.json"
    path.write_text(json.dumps(rows))
    got = troof.analyze(str(path))
    mf = troof.model_flops("tinyllama-1.1b", "train_4k", batch=16)
    assert got[0].model_flops == mf
    assert got[0].measured_fraction() == mf / troof.PEAK_FLOPS / 2.0
    assert got[0].peak_gib == 30.0
    table = troof.to_markdown(got)
    assert "measured frac" in table and "not measured" in table
    assert f"{mf / troof.PEAK_FLOPS / 2.0:.3f}" in table


# ---------------------------------------------------------------------------
# the dry run on the CPU
# ---------------------------------------------------------------------------
def _direct(cfg, kind, B, S):
    from repro_torch.models.layers import rope_freqs

    try:
        fn, args = dryrun._step_and_args(cfg, kind, B, S, 1)
        return tops.analyze_ops(tops.record_ops(fn, *args))
    finally:
        rope_freqs.cache_clear()


@pytest.mark.parametrize("arch,kind,depth", [
    ("tinyllama-1.1b", "train", 3), ("hymba-1.5b", "decode", 2),
    ("seamless-m4t-large-v2", "decode", 3), ("dbrx-132b", "prefill", 2)])
def test_depth_probes_give_the_full_depths_counts(arch, kind, depth):
    cfg = dataclasses.replace(smoke_config(arch), n_layers=depth)
    if cfg.enc_dec:
        cfg = dataclasses.replace(cfg, n_enc_layers=depth + 1)
    B, S = 2, 64
    probed = tops.analyze_ops(dryrun.abstract_pass(cfg, kind, B, S, 1))
    want = _direct(cfg, kind, B, S)
    assert probed["dot_flops"] == want["dot_flops"] > 0
    assert probed["memory_bytes"] == want["memory_bytes"] > 0


def test_run_cell_on_the_card_by_default():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.run_cell("tinyllama-1.1b", "train_4k", False)


@pytest.fixture(scope="module")
def cpu_cells(tmp_path_factory):
    """The dry run at the smoke configs' size (`get_config` patched)."""
    out = tmp_path_factory.mktemp("dryrun_torch")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dryrun, "get_config", smoke_config)
        rows = [dryrun.run_cell("tinyllama-1.1b", shape, False,
                                out_dir=str(out), device="cpu", batch=1,
                                verbose=False)
                for shape in ("train_4k", "decode_32k", "long_500k")]
    (out / "dryrun_results.json").write_text(json.dumps(rows))
    return out, rows


def test_run_cell_records_the_references_keys(cpu_cells):
    _, (train, decode, long) = cpu_cells
    assert long["status"] == "skipped" and long["reason"].startswith(
        "pure full-attention arch")
    for r, kind in ((train, "train"), (decode, "decode")):
        assert r["status"] == "ok", r.get("traceback")
        assert r["kind"] == kind and r["n_chips"] == 1
        assert r["step_s"] is None and r["peak_bytes"] is None   # CPU
        assert r["device"] == {"name": "cpu", "power_limit": None}
        assert r["flops"] > r["flops_raw"] > 0
        assert r["bytes_accessed"] > 0
        assert r["collective_bytes"]["total_bytes"] == 0.0
        assert r["memory"]["argument_size_bytes"] == \
            r["argument_bytes"]["total"] > 0
        assert r["batch"] == 1 and r["n_layers"] == 2
        assert r["kernels"] == {"flash_attention": 0, "ssd_scan": 0}
    assert train["reduced"] == ["batch 16 -> 1 (asked)"]
    assert decode["reduced"] == ["batch 8 -> 1 (asked)"]
    # 6 N D at the smoke model's depth, against the counted products
    mf = troof.model_flops("tinyllama-1.1b", "train_4k", batch=1)
    assert train["seq_len"] == 4096 and mf > 0


def test_run_cell_at_an_asked_depth(monkeypatch):
    monkeypatch.setattr(dryrun, "get_config", smoke_config)
    r = dryrun.run_cell("tinyllama-1.1b", "decode_32k", False, device="cpu",
                        batch=1, layers=1, verbose=False)
    assert r["status"] == "ok", r.get("traceback")
    assert r["n_layers"] == 1
    assert r["reduced"] == ["batch 8 -> 1 (asked)", "n_layers 2 -> 1 (asked)"]
    full = dryrun.argument_bytes(smoke_config("tinyllama-1.1b"), "decode_32k",
                                 False)
    assert r["argument_bytes"] == full                # the full cell's


def test_reprocess_round_trips(cpu_cells, capsys):
    out, rows = cpu_cells
    path = out / "dryrun_results.json"
    tampered = json.loads(path.read_text())
    for r in tampered:
        if r["status"] == "ok":
            r["flops"], r["bytes_accessed"] = 0.0, 0.0
    path.write_text(json.dumps(tampered))
    assert trep.reprocess(str(out)) == 2
    back = json.loads(path.read_text())
    for r, want in zip(back, rows):
        if want["status"] == "ok":
            assert r["flops"] == want["flops"]
            assert r["bytes_accessed"] == want["bytes_accessed"]
    assert "updated 2 cells" in capsys.readouterr().out


def test_listing_names_parse():
    assert trep.parse_tag("qwen2-7b__decode_32k__pod1__it2.ops.json.gz") == \
        ("qwen2-7b", "decode_32k", False, "__it2")
    assert trep.parse_tag("a__train_4k__pod2.ops.json.gz") == \
        ("a", "train_4k", True, "baseline")


@pytest.mark.parametrize("arch,shape", [
    ("tinyllama-1.1b", "train_4k"), ("qwen2-7b", "decode_32k"),
    ("dbrx-132b", "prefill_32k")])
def test_argument_bytes_follow_the_references_shard_shapes(arch, shape):
    mesh = jax.sharding.AbstractMesh((16, 16), ("data", "model"))
    cfg_j = j_get_config(arch)
    kind = SHAPES[shape].kind
    dt = jnp.float32 if kind == "train" else jnp.dtype(cfg_j.serve_params_dtype)
    ap = j_abstract_params(cfg_j, dtype=dt)
    sh = jsh.param_shardings(ap, mesh, tp_only=kind != "train"
                             and cfg_j.serve_tp_only)
    want = sum(int(np.prod(s.shard_shape(p.shape))) * p.dtype.itemsize
               for p, s in zip(jax.tree.leaves(ap), jax.tree.leaves(sh)))
    got = dryrun.argument_bytes(get_config(arch), shape, False)
    assert got["params"] == want
    if kind == "train":
        assert got["optimizer"] == 2 * want + 4


def test_per_chip_batches_are_the_rules():
    cfg = get_config("tinyllama-1.1b")
    assert [dryrun.per_chip_batch(cfg, s, False) for s in SHAPES] == \
        [16, 2, 8, 1]
    assert [dryrun.per_chip_batch(cfg, s, True) for s in SHAPES] == \
        [8, 1, 4, 1]
    dp = dataclasses.replace(cfg, dp_only=True)
    assert dryrun.per_chip_batch(dp, "train_4k", False) == 1


@pytest.mark.parametrize("kind,fits,want_layers,want_mb,want_reduced", [
    # train: the microbatches double while they divide the batch of 8,
    # then the depth halves
    ("train", {(2, 8)}, 2, 8,
     ["microbatches 2", "microbatches 4", "microbatches 8", "n_layers -> 4",
      "n_layers -> 2"]),
    ("train", {(8, 2)}, 8, 2, ["microbatches 2"]),
    # serving halves the depth only
    ("prefill", {(1, 1)}, 1, 1,
     ["n_layers -> 4", "n_layers -> 2", "n_layers -> 1"]),
    ("decode", set(), None, None,
     ["n_layers -> 4", "n_layers -> 2", "n_layers -> 1"])])
def test_out_of_memory_cuts_microbatches_then_layers(
        monkeypatch, kind, fits, want_layers, want_mb, want_reduced):
    """`fit_and_run` starts at full depth and one microbatch and takes the
    next cut after each out-of-memory error; below one layer, `NoFit`."""
    tried = []

    def card_step(cfg, kind_, B, S, mb, dev, calls):
        tried.append((cfg.n_layers, mb))
        if (cfg.n_layers, mb) not in fits:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. test")
        return {"step_s": 1.0}

    monkeypatch.setattr(dryrun, "_card_step", card_step)
    cfg = dataclasses.replace(smoke_config("tinyllama-1.1b"), n_layers=8)
    reduced: list = []
    if want_layers is None:
        with pytest.raises(dryrun.NoFit, match="out of memory at one layer"):
            dryrun.fit_and_run(cfg, kind, 8, 64, torch.device("cpu"), 1,
                               reduced)
    else:
        run_cfg, mb, res = dryrun.fit_and_run(
            cfg, kind, 8, 64, torch.device("cpu"), 1, reduced)
        assert (run_cfg.n_layers, mb, res) == (want_layers, want_mb,
                                               {"step_s": 1.0})
    assert tried[0] == (8, 1)
    assert [r.split(" (")[0] for r in reduced] == want_reduced
    assert all(r.endswith("(out of memory: CUDA out of memory. test)")
               for r in reduced)


# ---------------------------------------------------------------------------
# the hillclimb's loop
# ---------------------------------------------------------------------------
def _stub(arch, shape, multi_pod, verbose, device, batch, layers, calls,
          overrides=None, tag_suffix=""):
    o = overrides or {}
    chunk = o.get("ssm_chunk", 128)
    return {"status": "ok", "batch": 4 if batch is None else batch,
            "n_layers": 3, "microbatches": 1, "calls": calls,
            "reduced": [], "kernels": {},
            "flops": 1e15 * (0.5 if o.get("remat") == "dots" else 1.0),
            "bytes_accessed": 1e13 * chunk / 128,
            "collective_bytes": {"total_bytes": 0.0},
            "step_s": 1.0 + chunk / 128}


def test_hillclimb_pins_the_batch_and_refutes_dp_only(monkeypatch):
    seen = []

    def stub(*a, **kw):
        seen.append((kw["batch"], kw["layers"]))
        return _stub(*a, **kw)

    monkeypatch.setattr(hillclimb, "run_cell", stub)
    out: list = []
    arch, shape, steps = hillclimb.CELLS[0]
    hillclimb.iterate(arch, shape, steps, out, layers=3, device="cpu")
    assert seen == [(None, 3), (4, 3), (4, 3)]
    base, dp, chunk = out
    assert base["dominant"] == "memory" and base["step_s"] == 2.0
    assert dp["verdict"] == "REFUTED" and "no collective" in dp["note"]
    assert dp["bound_delta_pct"] == 0.0
    assert chunk["verdict"] == "CONFIRMED" and "note" not in chunk
    assert chunk["memory_s"] == base["memory_s"] / 2
    assert [c[0] for c in hillclimb.CELLS] == [
        "mamba2-130m", "hymba-1.5b", "qwen2-7b"]
