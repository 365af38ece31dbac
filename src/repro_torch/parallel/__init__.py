"""Distribution layer: mesh axes, per-architecture sharding rules, and
distributed-optimization collectives (deadline-ordered gradient
aggregation, compressed all-reduce) over `torch.distributed`.

Port of `repro/parallel`."""
from repro_torch.parallel.sharding import (
    batch_spec,
    cache_shardings,
    param_shardings,
    DATA_AXES,
    MODEL_AXIS,
)

__all__ = ["batch_spec", "cache_shardings", "param_shardings", "DATA_AXES", "MODEL_AXIS"]
