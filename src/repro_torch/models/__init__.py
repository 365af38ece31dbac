"""The LM substrate: layers, attention, the SSM mixer, MoE, the transformer
of every family and the model API (parameters, the training loss, prefill,
decode). Port of `repro/models`."""
from repro_torch.models.model import (
    abstract_cache,
    abstract_params,
    count_params,
    init_params,
    make_decode_step,
    make_loss_fn,
    make_prefill,
)

__all__ = ["abstract_cache", "abstract_params", "count_params", "init_params",
           "make_decode_step", "make_loss_fn", "make_prefill"]
