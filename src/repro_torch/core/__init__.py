"""RAELLA arithmetic on tensors: slicing, ADC, Center+Offset, crossbar,
speculation and the PIM linear layer."""
