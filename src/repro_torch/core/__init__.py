"""RAELLA arithmetic on tensors: slicing, ADC, Center+Offset, crossbar,
speculation and the PIM linear layer; and the paper's analytic models in
plain Python: crossbar mapping, the energy model, its workload tables."""
