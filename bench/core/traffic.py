"""The one generator of every traffic mix, from the mix's parameters and
the seed.

Request sizes are drawn by strata so that the work a window sees barely
depends on the seed: the pool is cut into blocks of ``block`` requests,
and every block holds the same ``block`` prompt lengths, the quantiles
``(k + 0.5) / block`` of the mix's distribution, paired with its output
lengths' quantiles in an order drawn from the seed. The block's requests
come in rounds of ``round``: the prompt quantiles fall into ``round``
groups of neighbours, and each round sends one prompt of every group, in
an order drawn from the seed. So two seeds send the same sizes in another
order, and a window that takes a few rounds, not only one that takes whole
blocks, takes nearly the same work. Token ids are uniform over the
vocabulary, drawn per request from ``(seed, stream, uid)``.
"""

from __future__ import annotations

import math
import statistics

import numpy as np

_NORMAL = statistics.NormalDist()
# independent streams of one seed
CALIBRATION, SIZES, PROMPTS, SAMPLE, BATCHES = range(5)


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def require(traffic: dict, **values) -> None:
    """Refuse a mix that asks for what its driver does not do."""
    bad = {k: traffic.get(k) for k, v in values.items()
           if traffic.get(k) != v}
    if bad:
        raise ValueError(f"traffic asks for {bad}; this driver does "
                         f"{values}")


def quantile(dist: dict, u: float) -> int:
    """The ``u`` quantile of a length distribution, a whole number within
    its ``min`` and ``max``: ``lognormal`` (``median``, ``sigma``), clipped,
    or ``uniform`` over the whole numbers ``min`` .. ``max``."""
    lo, hi = dist["min"], dist["max"]
    if dist["dist"] == "lognormal":
        x = dist["median"] * math.exp(dist["sigma"] * _NORMAL.inv_cdf(u))
        return int(min(max(round(x), lo), hi))
    if dist["dist"] == "uniform":
        return int(min(lo + math.floor(u * (hi - lo + 1)), hi))
    raise ValueError(f"unknown length distribution {dist['dist']!r}")


def request_sizes(traffic: dict, seed: int) -> list[tuple[int, int]]:
    """``(prompt_len, new_tokens)`` of every request of the pool, in the
    order the clients send them."""
    k, r = traffic["block"], traffic["round"]
    if traffic["pool"] % k or k % r:
        raise ValueError("pool must be a whole number of blocks, and a "
                         "block a whole number of rounds")
    g = rng(seed, SIZES)
    us = [(i + 0.5) / k for i in range(k)]
    out_lens = [quantile(traffic["output_len"], u) for u in us]
    prompt_q = [quantile(traffic["prompt_len"], u) for u in us]
    sizes = []
    for _ in range(traffic["pool"] // k):
        pair = g.permutation(k)
        groups = g.permuted(np.arange(k).reshape(r, k // r), axis=1)
        for t in range(k // r):
            sizes += [(prompt_q[j], out_lens[pair[j]])
                      for j in g.permutation(groups[:, t])]
    return sizes


def prompt(seed: int, uid: int, n: int, vocab: int) -> np.ndarray:
    return rng(seed, PROMPTS, uid).integers(0, vocab, n).astype(np.int64)


def calibration_tokens(config: dict, seed: int) -> np.ndarray:
    """The calibration prompts of the PIM compile, which the plain
    reference is handed too."""
    cal = config["calibration"]
    return rng(seed, CALIBRATION).integers(
        0, config["model"]["vocab_size"],
        (cal["batch"], cal["seq_len"])).astype(np.int64)


def batches(traffic: dict, vocab: int, seed: int) -> np.ndarray:
    """The encode mix's ``(pool, batch, seq_len)`` token ids; forward i
    takes ``pool[i % len(pool)]``."""
    return rng(seed, BATCHES).integers(
        0, vocab, (traffic["pool"], traffic["batch"],
                   traffic["seq_len"])).astype(np.int64)
