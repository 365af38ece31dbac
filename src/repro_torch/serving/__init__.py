"""Serving: KV-cache slots and the continuous-batching engine.
Port of `repro/serving` (single replica; the replicated service waits for
the event-driven backend)."""
