"""Port of `repro/parallel`: so far only the int8 gradient compression of
`collectives.py`; the sharding rules and the other collectives are not
ported yet."""
from repro_torch.parallel.collectives import (
    int8_compress_decompress,
    int8_dequantize,
    int8_quantize,
)

__all__ = ["int8_quantize", "int8_dequantize", "int8_compress_decompress"]
