"""Model-level parity of the port with the reference: reduced float32
yi-6b (GQA) with the reference's weights carried across.

Teacher-forced prefill + decode logits of the port are held to the
reference's in all four ``pim_mode``s within the tolerances stated in
``_torch_parity`` (argmax equal wherever the reference's top-2 margin
exceeds them); compiled plans are held leaf by leaf; inside the port,
``int8`` and ``exact`` logits are equal bit for bit at the 24b ADC.
"""

import numpy as np
import pytest

import _torch_parity as P
from _torch_parity import one_thread  # noqa: F401  (autouse fixture)

ARCH = "yi-6b"


def test_configs_compare_equal():
    import dataclasses
    rcfg, cfg = P.setup(ARCH)[:2]
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(cfg)


@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_plans_match_reference(mode):
    P.check_plans(ARCH, mode)


@pytest.mark.parametrize("mode", P.MODES)
def test_logits_match_reference(mode):
    P.check_logits(ARCH, mode)


def test_int8_equals_exact_in_port():
    np.testing.assert_array_equal(P.port_logits(ARCH, "int8"),
                                  P.port_logits(ARCH, "exact"))
