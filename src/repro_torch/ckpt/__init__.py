"""Port of `repro/ckpt`: the Nezha-replicated training-metadata log.
`checkpoint.py` goes with the trainer, which is not ported yet."""
from repro_torch.ckpt.replicated_log import ReplicatedMetadataLog

__all__ = ["ReplicatedMetadataLog"]
