"""Port of `repro/data`: the deterministic synthetic token pipeline."""
from repro_torch.data.pipeline import (
    DataConfig,
    SyntheticTokenDataset,
    make_host_iterator,
)

__all__ = ["DataConfig", "SyntheticTokenDataset", "make_host_iterator"]
