"""The paper's noise and die artifacts through the port against the
reference's: Fig. 15 (``run`` over noise levels, ``run_device_corners``,
the ``--device-corner`` command line) and Table 4's corner sweep.

Both sides run on the reference's trained classifier, with the
reference's ``jax.random`` draws stood in for the port's keys
(``_torch_parity.JaxKey``): the evaluation batch, Algorithm 1's noisy
search, each layer's ADC noise (``KEY(seed).fold_in(idx)``) and each
die's fault maps and write errors. Held: Algorithm 1's slicing choice
with ``==``, and every accuracy within 2 / ``EVAL_N``: the noisy read
adds float32 draws to sums that the two libraries reduce in different
orders, so one or two conversions that sit on a rounding boundary may
round the other way and move one argmax (``test_torch_nonideal.py``
bounds those flips per read). Training is shortened to ``STEPS``.
"""

import numpy as np
import pytest

from benchmarks import fig15_noise as r_fig15
from benchmarks import table4_accuracy as r_table4
from repro_torch.paper import fig15_noise, table4_accuracy

from _torch_parity import one_thread  # noqa: F401  (autouse fixture)
from _torch_parity import reference_draws, reference_mlp  # noqa: F401

STEPS = 40
EVAL_N = 128
TOL = 2 / EVAL_N


def _close(got: dict, want: dict, path: str = "") -> None:
    """Accuracies within TOL, everything else ``==``, key by key."""
    assert set(got) == set(want), path
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _close(g, w, f"{path}.{k}")
        elif isinstance(w, float) and ("acc" in k or k in (
                "isaac", "center_offset", "adaptive", "raella",
                "float_reference") or k.startswith("corner")):
            assert abs(g - w) <= TOL, (f"{path}.{k}", g, w)
        elif k == "drop_pts":
            assert abs(g - w) <= 100 * 2 * TOL + 1e-9, (f"{path}.{k}", g, w)
        else:
            assert g == w, (f"{path}.{k}", g, w)


def test_fig15_noise_levels_on_reference_weights(reference_mlp):
    """Noise 0 (ISAAC at 128-row segments through K1's plain version at
    the unsigned 8b ADC, C+O and Algorithm 1's slicing through K1, RAELLA
    through K2) and 0.08 (the noisy loops): every arm's accuracy, the
    slice count Algorithm 1 picks at each level."""
    levels = (0.0, 0.08)
    got = fig15_noise.run(levels, eval_n=EVAL_N, train_steps=STEPS,
                          device="cpu")
    want = r_fig15.run(levels, eval_n=EVAL_N, train_steps=STEPS)
    _close(got, want)
    assert got["noise_0.08"]["adaptive_n_slices"] >= \
        got["noise_0.00"]["adaptive_n_slices"]


def test_fig15_device_corners_on_reference_weights(reference_mlp):
    """One compiled plan read through nominal (== the ideal simulation)
    and 3-sigma dies."""
    corners = ("nominal", "3sigma")
    got = fig15_noise.run_device_corners(corners, eval_n=EVAL_N,
                                         train_steps=STEPS, device="cpu")
    want = r_fig15.run_device_corners(corners, eval_n=EVAL_N,
                                      train_steps=STEPS)
    assert got["slicing"] == want["slicing"]
    _close(got, want)
    assert got["corner_nominal"]["drop_pts"] == 0.0


def test_table4_device_corners_on_reference_weights(reference_mlp):
    """Both encodings, each compiled once, read through nominal and
    1-sigma dies."""
    corners = ("nominal", "1sigma")
    got = table4_accuracy.run_device_corners(corners, train_steps=STEPS,
                                             eval_n=EVAL_N, device="cpu")
    want = r_table4.run_device_corners(corners, train_steps=STEPS,
                                       eval_n=EVAL_N)
    _close(got, want)


def test_fig15_device_corner_command_line():
    """``--device-corner 1sigma`` sweeps nominal..1sigma on one plan, on
    the port's own keys and training; the nominal die equals the ideal
    simulation, so it loses nothing against the float model."""
    res = fig15_noise.main(["--device-corner", "1sigma", "--eval-n", "64",
                            "--train-steps", "20", "--device", "cpu"])
    assert [k for k in res if k.startswith("corner_")] == \
        ["corner_nominal", "corner_1sigma"]
    assert all(v["dies"] == 1 for k, v in res.items()
               if k.startswith("corner_"))
    assert np.isfinite(res["corner_1sigma"]["accuracy"])
