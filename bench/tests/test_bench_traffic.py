"""A seed gives the same requests every time; two seeds send the same
sizes in another order."""

import statistics
from collections import Counter

import numpy as np
import pytest

from bench.core import spec as specs
from bench.core import traffic as gen

SERVE = ["sharegpt48", "azure-code4"]
BIG = 2 ** 31 + 12345  # past 32 signed bits


def mix(name):
    return specs.read_json(specs.BENCH / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", SERVE)
def test_same_seed_same_requests(name):
    t = mix(name)
    assert gen.request_sizes(t, BIG) == gen.request_sizes(t, BIG)
    a = gen.prompt(BIG, 7, 100, 152064)
    assert np.array_equal(a, gen.prompt(BIG, 7, 100, 152064))
    assert not np.array_equal(a, gen.prompt(BIG + 1, 7, 100, 152064))
    assert a.min() >= 0 and a.max() < 152064


@pytest.mark.parametrize("name", SERVE)
def test_seeds_share_sizes_block_by_block(name):
    t = mix(name)
    k = t["block"]
    a, b = gen.request_sizes(t, 1), gen.request_sizes(t, BIG)
    assert a != b and len(a) == t["pool"]
    for i in range(0, t["pool"], k):
        assert Counter(x[1] for x in a[i:i + k]) == \
            Counter(x[1] for x in b[i:i + k])
        assert Counter(x[0] for x in a[i:i + k]) == \
            Counter(x[0] for x in b[i:i + k])
    for plen, new in a:
        assert t["prompt_len"]["min"] <= plen <= t["prompt_len"]["max"]
        assert t["output_len"]["min"] <= new <= t["output_len"]["max"]
        assert plen + new <= t["engine"]["max_len"]


@pytest.mark.parametrize("name", SERVE)
def test_every_round_sends_one_prompt_of_each_group(name):
    t = mix(name)
    k, r = t["block"], t["round"]
    strata = sorted(gen.quantile(t["prompt_len"], (i + 0.5) / k)
                    for i in range(k))
    groups = [strata[g * k // r:(g + 1) * k // r] for g in range(r)]
    sizes = gen.request_sizes(t, BIG)
    for at in range(0, len(sizes), r):
        plens = sorted(p for p, _ in sizes[at:at + r])
        assert all(p in grp for p, grp in zip(plens, groups)), (at, plens)


@pytest.mark.parametrize("name", SERVE)
def test_lengths_keep_their_published_statistics(name):
    """Each mix names its public source, and the sizes every block sends
    hold the statistic that source publishes, within 1%."""
    t = mix(name)
    assert t["source"] and t["assumed"]
    block = gen.request_sizes(t, BIG)[:t["block"]]
    for i, key in enumerate(("prompt_len", "output_len")):
        lens = [x[i] for x in block]
        for stat, want in t["published"][key].items():
            got = getattr(statistics, stat)(lens)
            assert abs(got - want) <= 0.01 * want, (key, stat, got, want)


def test_quantiles():
    logn = {"dist": "lognormal", "median": 96, "sigma": 0.5, "min": 32,
            "max": 256}
    assert gen.quantile(logn, 0.5) == 96
    assert gen.quantile(logn, 1e-9) == 32 and gen.quantile(logn, 1 - 1e-9) \
        == 256
    uni = {"dist": "uniform", "min": 8, "max": 32}
    vals = [gen.quantile(uni, (i + 0.5) / 25) for i in range(25)]
    assert vals == list(range(8, 33))


def test_encode_batches_and_calibration():
    t = mix("squad384")
    a = gen.batches(t, 30522, BIG)
    assert a.shape == (t["pool"], t["batch"], t["seq_len"])
    assert np.array_equal(a, gen.batches(t, 30522, BIG))
    cfg = specs.read_json(specs.BENCH / "configs" / "qwen2.5-32b.json")
    c = gen.calibration_tokens(cfg, BIG)
    assert np.array_equal(c, gen.calibration_tokens(cfg, BIG))
    assert c.shape == (2, 64)
