"""Port of `repro/ckpt`: atomic checkpoints with an integrity hash, and
the Nezha-replicated training-metadata log they commit through."""
from repro_torch.ckpt.checkpoint import (
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.ckpt.replicated_log import ReplicatedMetadataLog

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "ReplicatedMetadataLog"]
