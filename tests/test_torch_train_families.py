"""Training on the port against the reference's for the other five
families at `smoke_config` size (hybrid hymba-1.5b, MoE dbrx-132b and
arctic-480b -- whose moments are bf16 --, encoder-decoder
seamless-m4t-large-v2, vision frontend phi-3-vision-4.2b): the checks and
tolerances of `tests/test_torch_train.py`, in a file of its own so that
the two spread over two test workers."""
import pytest

from test_torch_train import (
    Setup,
    check_int8,
    check_loss_and_grads,
    check_microbatches,
    check_remat,
    check_train_step,
    f32_compute,  # noqa: F401  (the module-wide float32 compute)
)

FAMILIES = ["hymba-1.5b", "dbrx-132b", "arctic-480b",
            "seamless-m4t-large-v2", "phi-3-vision-4.2b"]


@pytest.fixture(scope="module", params=FAMILIES)
def fam(request):
    return Setup(request.param)


def test_loss_and_grads_match_the_reference(fam, monkeypatch):
    check_loss_and_grads(fam, monkeypatch)


def test_train_step_matches_the_reference(fam, monkeypatch):
    check_train_step(fam, monkeypatch)


def test_microbatches_match_the_reference(fam, monkeypatch):
    check_microbatches(fam, monkeypatch)


def test_int8_compression_matches_the_reference(fam, monkeypatch):
    check_int8(fam, monkeypatch)


def test_remat_policies_agree(fam):
    check_remat(fam)


def test_bf16_moments_stay_bf16(fam, monkeypatch):
    """arctic-480b keeps its AdamW moments in bf16, as the reference's
    `make_train_state` does; the other families in float32."""
    import torch

    from repro_torch.train.train_step import make_train_state

    state = make_train_state(fam.cfg_t, seed=0, device="cpu")
    abstract = make_train_state(fam.cfg_t)
    want = torch.bfloat16 if fam.name == "arctic-480b" else torch.float32
    for st in (state, abstract):
        assert st.opt.m["embed"].dtype == st.opt.v["embed"].dtype == want
        assert st.params["embed"].dtype == torch.float32
    assert abstract.params["embed"].device.type == "meta"
    assert state.opt.step.dtype == torch.int32 and int(state.opt.step) == 0
