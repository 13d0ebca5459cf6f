"""The work behind ``k2_roofline.*`` and ``mfu.*`` is counted from shapes,
rows and slicing: the same window described as one launch per signed pass
or as one fused launch counts the same."""

import math

import pytest

from bench.core import spec as specs
from bench.work import model as work

CFG = specs.read_json(specs.BENCH / "configs" / "qwen2.5-32b.json")
MODEL, PIM = CFG["model"], CFG["pim"]
# a small window: two prefill chunks (64 and 17 rows, head at 1 row) and
# three decode steps of 16 rows
CALLS = [(64, 1), (17, 1), (16, 16), (16, 16), (16, 16)]


def launches(fused: bool) -> list:
    out = []
    for e, (B, R, C) in enumerate(work.window_executions(MODEL, CALLS)):
        for _ in range(1 if fused else 2):
            out.append({"execution": e, "B": B, "R": R, "C": C})
    return out


def test_fused_and_per_pass_launches_count_the_same():
    per_pass = work.k2_work_of(work.executions_of(launches(False)), PIM)
    fused = work.k2_work_of(work.executions_of(launches(True)), PIM)
    assert per_pass == fused
    assert per_pass == work.k2_work(MODEL, PIM, CALLS)


def test_frozen_per_call_arithmetic():
    """One execution equals ``chip_smoke.py``'s ``kernel_calls`` sums of
    its two signed-pass calls, less the second pass's reads (the planes,
    centers, codes and result are counted once, and no counters)."""
    B, R, C, n_j, n_i, rx = 16, 27648, 5120, 3, 3, 512
    n_seg = math.ceil(R / rx)
    smoke_ops = 2 * (2 * B * R * C * n_j * n_i)
    smoke_one_pass = (4 * B * R + n_j * n_seg * rx * C + 4 * n_i * n_j
                      + 4 * n_seg * C + 4 * B * C + 8 * (n_i + 1))
    ops, nbytes = work.k2_execution(B, R, C, n_j, n_i)
    assert ops == smoke_ops
    assert nbytes == smoke_one_pass - 4 * n_i * n_j - 8 * (n_i + 1)


def test_decode_step_bound_is_the_planes():
    ops, nbytes = work.k2_work(MODEL, PIM, [(16, 16)])
    weights = MODEL["n_layers"] * sum(R * C for _, R, C in
                                      work.layer_projections(MODEL)) \
        + MODEL["d_model"] * MODEL["vocab_size"]
    assert nbytes > 3 * weights
    assert work.least_seconds(ops, nbytes) == pytest.approx(
        nbytes / work.HBM_BYTES_PER_S)


def test_useful_ops():
    d, v = MODEL["d_model"], MODEL["vocab_size"]
    proj = sum(R * C for _, R, C in work.layer_projections(MODEL))
    got = work.useful_ops(MODEL, 10, 2, 100)
    attn = 4 * MODEL["n_heads"] * MODEL["head_dim"] * 100
    assert got == MODEL["n_layers"] * (20 * proj + attn) + 4 * d * v
