"""The LM substrate: layers, attention, the SSM mixer, MoE, the transformer
of every family and the model API. Port of `repro/models` (all but the
training loss)."""
