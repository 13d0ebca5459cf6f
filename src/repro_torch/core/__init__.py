"""RAELLA arithmetic on tensors: slicing, ADC, Center+Offset, crossbar,
speculation and the PIM linear layer; and the paper's analytic models in
plain Python: crossbar mapping, the energy model, its workload tables.

Submodules, imported here as the reference's package imports its own:
  slicing        bit-slice arithmetic (D(h,l,x), 108 slicings)
  backends       CrossbarBackend: IdealSim / NonidealSim device models
  center_offset  Eq. 2 center solve + 2T2R offset encoding
  adc            7b saturating ADC + analog noise model
  crossbar       bit-exact 512-row crossbar forward
  speculation    dynamic input slicing (speculate/recover)
  adaptive       Algorithm 1 adaptive weight slicing
  pim_linear     RaellaLinear layer (exact | fast | off)
  energy         Titanium Law + component energy/throughput model
  mapping        layer -> crossbar/IMA/tile mapping & replication
  workloads      the paper's seven evaluation DNNs
"""

from repro_torch.core import (  # noqa: F401
    adaptive,
    adc,
    backends,
    center_offset,
    crossbar,
    energy,
    mapping,
    pim_linear,
    slicing,
    speculation,
    workloads,
)
