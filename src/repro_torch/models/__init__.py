"""Dense transformer assembly, PIM-backed projections and the plan compiler.

Re-exports the reference's package surface: the ``layers``, ``pim``,
``ssm`` and ``transformer`` submodules and the model's entry points."""

from repro_torch.models import layers, pim, ssm, transformer  # noqa: F401
from repro_torch.models.transformer import (  # noqa: F401
    decode_step,
    forward,
    init_decode_state,
    init_params,
    lm_loss,
    param_specs,
    prefill,
)
