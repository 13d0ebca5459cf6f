"""8b quantization (paper §2.1)."""

from repro_torch.quant.quantize import (
    LayerQuant,
    QuantizedTensor,
    dequantize,
    quantize_inputs_signed,
    quantize_inputs_unsigned,
    quantize_weights_centered,
    quantize_weights_per_channel,
    requantize_outputs,
)

__all__ = [
    "LayerQuant",
    "QuantizedTensor",
    "dequantize",
    "quantize_inputs_signed",
    "quantize_inputs_unsigned",
    "quantize_weights_centered",
    "quantize_weights_per_channel",
    "requantize_outputs",
]
