"""The window's reduction on the program's spans (``core.program_trace``),
on records made up here: device intervals on a Unix-like clock, the
harness's and the program's host spans on a host clock, two clock pairs."""

import pytest

from bench.core import program_trace as pt
from bench.core import trace

D0 = 1_792_374_601_000_000_000  # device (Unix) nanoseconds at host 0
RECS = [("void spec_kernel<4>(int const*)", D0 + 100, D0 + 200),
        ("fill", D0 + 150, D0 + 250), ("Memcpy HtoD (Pageable -> Device)",
                                       D0 + 410, D0 + 420),
        ("spec_kernel", D0 + 430, D0 + 500),
        ("Memcpy DtoH (Device -> Pageable)", D0 + 900, D0 + 960)]
# (name, start, end, parent, args) on the host clock, in start order
PROGRAM = {
    "spans": [["step", 0, 1000, -1, []],
              ["decode_step", 10, 990, 0, []],
              ["h2d_tokens", 380, 430, 1, []],
              ["model.decode_step", 430, 880, 1, []],
              ["pim.call", 500, 690, 3, [48, 5120, 7168, "exact"]],
              ["pim.tables", 520, 560, 4, []],
              ["pim.call", 720, 860, 3, [48, 5120, 7168, "exact"]],
              ["fetch", 880, 980, 1, []]],
    "counters": {"pim_calls": 2, "host_syncs": 3},
    "syncs": [2, 7, 5],
    "clock": [[0, D0], [10_000, D0 + 10_000]]}


class Window:
    """A tracer's leftovers: the records and the host clock at the
    window's start; the first record came 100 ns after it."""
    records = RECS
    host_start_ns = 0


def rec_of(program=PROGRAM, window_s=1000 / 1e9) -> dict:
    return {"window_s": window_s, "program": program,
            "trace": pt.summary(Window, [("decode_step host and fetch", 5,
                                          995)], program, window_s)}


def test_same_busy_and_kernel_times_as_the_old_summary():
    old = trace.summary(Window, [])
    new = rec_of()["trace"]
    assert new["busy_s"] == old["busy_s"] == (150 + 10 + 70 + 60) / 1e9
    assert new["kernels"] == old["kernels"]
    assert new["breakdown"]["device_ops"] == old["breakdown"]["device_ops"]


def test_idle_time_by_innermost_program_span():
    """Idle on the device clock: 0-100 (step, decode_step), 250-410
    (decode_step, h2d_tokens), 420-430 (h2d_tokens), 500-900 (pim.call,
    pim.tables, model.decode_step, fetch), 960-1000 (fetch, decode_step,
    step); the gaps between records named by their midpoints' innermost
    span, the program's inside the harness's."""
    t = rec_of()["trace"]
    want = {"step": 10 + 10, "decode_step": 90 + 130 + 10,
            "h2d_tokens": 30 + 10, "pim.call": 20 + 130 + 140,
            "pim.tables": 40, "model.decode_step": 30 + 20,
            "fetch": 20 + 20}
    got = {k: round(v * 1e9) for k, v in t["idle_by_span"].items()}
    assert got == want
    assert sum(want.values()) == 1000 - 290
    gaps = dict(t["breakdown"]["idle_gaps"])
    # gaps between records: 250-410 (mid 330: decode_step), 420-430 (mid
    # 425: h2d_tokens), 500-900 (mid 700: model.decode_step, between the
    # two calls), 960-1000 not between records
    assert gaps["all idle gaps in decode_step"] == pytest.approx(160e-9)
    assert gaps["all idle gaps in h2d_tokens"] == pytest.approx(10e-9)
    assert gaps["all idle gaps in model.decode_step"] == pytest.approx(
        400e-9)
    assert t["syncs_by_span"] == {"h2d_tokens": 1, "fetch": 1,
                                  "pim.tables": 1}
    # the old offset (first record 100 ns after the window's start) put
    # host time 100 ns late on the device clock
    assert t["old_offset_error_us"] == pytest.approx(0.1)


def test_readers():
    rec = rec_of()
    assert pt.idle_pim_host(rec, None) == pytest.approx(
        100 * (290 + 40) / 1000)
    assert pt.idle_engine_host(rec, None) == pytest.approx(
        100 * (20 + 40 + 40) / 1000)
    assert pt.pim_host_us(rec, None) == pytest.approx((190 + 140) / 2e3)
    assert pt.host_syncs_per_iter(rec, None) == 3.0
    bare = {"window_s": 1.0, "trace": trace.summary(Window, [])}
    for read in (pt.idle_pim_host, pt.idle_engine_host, pt.pim_host_us,
                 pt.host_syncs_per_iter):
        assert read(bare, None) is None
        assert read({"window_s": 1.0, "trace": None}, None) is None


def test_clock_pairs_move_the_spans():
    """A program clock 5 us behind the device one and 1% slow places
    every span by the pairs."""
    prog = dict(PROGRAM, clock=[[0, D0 + 5_000], [1000, D0 + 6_010]])
    spans = pt.mapped_spans(prog)
    assert spans[0][1:3] == [D0 + 5_000, D0 + 6_010]
    assert spans[-1][1:3] == [D0 + 5_889, D0 + 5_990]  # 888.8, 989.8


def test_copy_checks():
    """The logits copy ends inside the decode step's fetch and the tokens'
    copy starts inside h2d_tokens; shifted 100 ns, both miss."""
    assert pt.copy_checks(RECS, PROGRAM) == {
        "fetch_spans": 1, "fetch_violations": 0, "h2d_spans": 1,
        "h2d_violations": 0}
    assert pt.copy_checks(RECS, PROGRAM, shift_ns=-100) == {
        "fetch_spans": 1, "fetch_violations": 1, "h2d_spans": 1,
        "h2d_violations": 1}


def test_self_segments_partition_each_span():
    starts, ends, owner = pt.self_segments(PROGRAM["spans"])
    assert list(zip(starts.tolist(), ends.tolist(), owner.tolist())) == [
        (0, 10, 0), (10, 380, 1), (380, 430, 2), (430, 500, 3),
        (500, 520, 4), (520, 560, 5), (560, 690, 4), (690, 720, 3),
        (720, 860, 6), (860, 880, 3), (880, 980, 7), (980, 990, 1),
        (990, 1000, 0)]
    assert pt.idle_by_owner([(0, 5), (995, 1010)], starts, ends, owner) == {
        0: 10, -1: 10}


def test_copy_places_tell_a_lost_record_from_a_moved_one():
    """Every copy record by the innermost span holding it: inside the
    spans that issue them; one copy moved 25 ns past its fetch lies in the
    decode step; one the profiler lost lies nowhere."""
    assert pt.copy_places(RECS, PROGRAM) == {
        "fetch_spans": 1, "dtoh_records": {"fetch": 1},
        "h2d_tokens_spans": 1, "htod_records": {"h2d_tokens": 1}}
    moved = RECS[:-1] + [("Memcpy DtoH (Device -> Pageable)", D0 + 925,
                          D0 + 985)]
    lost = RECS[:-1]
    assert pt.copy_checks(moved, PROGRAM)["fetch_violations"] == 1
    assert pt.copy_places(moved, PROGRAM)["dtoh_records"] == {
        "decode_step": 1}
    assert pt.copy_checks(lost, PROGRAM)["fetch_violations"] == 1
    assert pt.copy_places(lost, PROGRAM)["dtoh_records"] == {}
    far = RECS + [("Memcpy DtoH (Device -> Pageable)", D0 + 2000,
                   D0 + 2100)]
    assert pt.copy_places(far, PROGRAM)["dtoh_records"] == {
        "fetch": 1, pt.NO_SPAN: 1}
