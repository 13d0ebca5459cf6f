"""The traced window's reduction, on records made up here."""

from bench.core import trace


def tracer_with(records, start):
    t = trace.Tracer(False)
    t.records = records
    t.host_start_ns = start
    return t


def test_union_and_gaps():
    recs = [("void spec_kernel<4>(int const*)", 100, 200),
            ("fill", 150, 250), ("spec_kernel", 400, 500),
            ("copy", 900, 1000)]
    assert trace.merge([(s, e) for _, s, e in recs]) == \
        [(100, 250), (400, 500), (900, 1000)]
    spans = [("decode", 0, 320), ("prefill", 500, 900)]
    s = trace.summary(tracer_with(recs, 0), spans)
    assert s["busy_s"] == 350 / 1e9
    k2 = sum(v[1] for k, v in s["kernels"].items() if "spec_kernel" in k)
    assert k2 == 200 / 1e9
    idle = dict(s["breakdown"]["idle_gaps"])
    # gap 250..400 (mid 325 - offset 100 = 225: in "decode"), 500..900
    # (mid 700 - 100 = 600: in "prefill")
    assert idle["all idle gaps in decode"] == 150 / 1e9
    assert idle["all idle gaps in prefill"] == 400 / 1e9
    assert s["breakdown"]["device_ops"][0][0] == "spec_kernel<4>"


def test_nothing_traced():
    assert trace.summary(tracer_with([], 0), []) is None
    assert trace.short_name("void at::native::foo<1>(int)") == "foo<1>"
