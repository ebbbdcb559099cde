from repro_torch.optim.compress import dequantize_int8, quantize_int8

__all__ = ["dequantize_int8", "quantize_int8"]
