"""8b quantization (paper §2.1)."""
