"""The traced window: device records from ``torch.profiler``.

With ``--trace 1`` the measured window runs under ``torch.profiler`` with
device activity only (CUPTI's records of every kernel, copy and fill; no
host-op records, which cost more than the window itself). The records are
read raw from the profiler's results, never through a Chrome-trace export,
and reduced here: the union of device intervals (busy seconds), device
seconds by kernel name, and the idle gaps, each named by what the host was
doing then (the drivers' host spans, put on the device clock by the offset
between the window's start and its first device record).
"""

from __future__ import annotations

import re
import time

import numpy as np
import torch


class Tracer:
    """Context manager around the measured window; inert when ``on`` is
    false (no profiler is started)."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.host_start_ns = 0
        self.records: list[tuple[str, int, int]] = []

    def __enter__(self):
        if self.on:
            # the autograd profiler's kineto tracing, device activity only,
            # stopped below without building its Python event tree
            from torch.autograd import profiler
            self.prof = profiler.profile(use_cpu=False, use_device="cuda",
                                         use_kineto=True)
            self.prof._prepare_trace()
            self.prof._start_trace()
        self.host_start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.prof is None:
            return False
        from torch.autograd import _disable_profiler
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = _disable_profiler()
        t1 = time.perf_counter()
        for e in results.events():
            if not str(e.device_type()).endswith("CUDA"):
                continue
            dur = e.duration_ns()
            if dur > 0:
                start = e.start_ns()
                self.records.append((e.name(), start, start + dur))
        self.stop_s, self.read_s = t1 - t0, time.perf_counter() - t1
        self.prof = None
        return False


def merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def short_name(kernel: str) -> str:
    """A kernel's name without its namespaces and arguments, at most 90
    characters."""
    name = re.sub(r"void |at::native::|\(anonymous namespace\)::|"
                  r"at::detail::|at::cuda::", "", kernel)
    return re.sub(r"\(.*$", "", name)[:90]


def by_name(records) -> dict[str, list]:
    """``{name: [count, seconds]}`` of the device records."""
    out: dict[str, list] = {}
    for name, s, e in records:
        t = out.setdefault(name, [0, 0.0])
        t[0] += 1
        t[1] += (e - s) / 1e9
    return out


OUTSIDE = "between the harness's host spans"


def labels_of(times: np.ndarray, spans: list[tuple[str, int, int]]) -> list:
    """For each host time, the label of the innermost host span holding
    it. Spans of one label never overlap (one host thread runs them in
    turn); spans of different labels may nest."""
    best_len = np.full(len(times), np.inf)
    best = np.full(len(times), OUTSIDE, dtype=object)
    for label in {s[0] for s in spans}:
        iv = np.array(sorted((s, e) for lab, s, e in spans if lab == label),
                      dtype=np.int64)
        i = np.searchsorted(iv[:, 0], times, side="right") - 1
        ok = i >= 0
        ok[ok] = times[ok] <= iv[i[ok], 1]
        length = np.where(ok, iv[np.maximum(i, 0), 1] - iv[np.maximum(i, 0),
                                                             0], np.inf)
        better = length < best_len
        best_len[better] = length[better]
        best[better] = label
    return list(best)


def summary(tracer: Tracer, spans: list[tuple[str, int, int]],
            top: int = 10) -> dict | None:
    """``busy_s``, device seconds by kernel name, and the breakdown the
    result line carries: the ``top`` kernels by device time and the idle
    gaps by host span (their sums per span kind, then the longest gaps).
    None when nothing was traced."""
    recs = tracer.records
    if not recs:
        return None
    busy = merge([(s, e) for _, s, e in recs])
    busy_s = sum(e - s for s, e in busy) / 1e9
    names = by_name(recs)
    device_ops = sorted(([short_name(k), v[1]] for k, v in names.items()),
                        key=lambda r: r[1], reverse=True)
    merged_ops: dict[str, float] = {}
    for name, sec in device_ops:
        merged_ops[name] = merged_ops.get(name, 0.0) + sec
    offset = busy[0][0] - tracer.host_start_ns
    ends = np.array([e for _, e in busy[:-1]], dtype=np.int64)
    starts = np.array([s for s, _ in busy[1:]], dtype=np.int64)
    gaps = list(zip(labels_of((ends + starts) // 2 - offset, spans),
                    ((starts - ends) / 1e9).tolist()))
    per_label: dict[str, float] = {}
    for label, sec in gaps:
        per_label[label] = per_label.get(label, 0.0) + sec
    idle = [[f"all idle gaps in {k}", v] for k, v in
            sorted(per_label.items(), key=lambda kv: kv[1], reverse=True)]
    longest = sorted(gaps, key=lambda g: g[1], reverse=True)
    idle += [[f"one gap in {label}", sec]
             for label, sec in longest[:max(0, top - len(idle))]]
    return {"busy_s": busy_s, "kernels": names,
            "breakdown": {
                "device_ops": sorted(([k, v] for k, v in merged_ops.items()),
                                     key=lambda r: r[1],
                                     reverse=True)[:top],
                "idle_gaps": idle[:top]}}
