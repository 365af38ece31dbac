"""Serving: KV-cache slots, the continuous-batching engine and the
Nezha-replicated LM service. Port of `repro/serving`."""
from repro_torch.serving.engine import ReplicatedLMService, ServingEngine

__all__ = ["ServingEngine", "ReplicatedLMService"]
