"""The LM substrate: layers, attention, the dense transformer and the
model API. Port of `repro/models` (dense family)."""
