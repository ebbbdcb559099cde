from repro_torch.optim.adamw import AdamW
from repro_torch.optim.compress import dequantize_int8, quantize_int8

__all__ = ["AdamW", "dequantize_int8", "quantize_int8"]
