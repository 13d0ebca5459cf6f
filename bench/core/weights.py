"""A configuration's weights, made from the seed on the device.

All of a model's values are drawn in one ``torch.randn`` call on the
device's own generator, in the dtype they are served in, then each leaf,
a view of that buffer, is scaled in place: matrices by their fan-in ** -0.5,
QKV biases to a standard deviation of 0.1, norm scales to 1 + 0.05 z. The
tree has the layout the port's models take (``embed``, ``layers``,
``final_norm``); both the program and the plain reference read these very
tensors.
"""

from __future__ import annotations

import math

import torch

BIAS_STD = 0.1
NORM_STD = 0.05


def leaves(model: dict) -> list[tuple[tuple, tuple, str, float]]:
    """``(path, shape, kind, scale)`` of every leaf, kind being ``matrix``,
    ``bias`` or ``norm``."""
    d, f, v = model["d_model"], model["d_ff"], model["vocab_size"]
    hd, h, kv = model["head_dim"], model["n_heads"], model["n_kv_heads"]
    out = [(("embed", "embed"), (v, d), "matrix", d ** -0.5),
           (("embed", "head"), (d, v), "matrix", d ** -0.5),
           (("final_norm", "scale"), (d,), "norm", NORM_STD)]
    for i in range(model["n_layers"]):
        lay = ("layers", i)
        out += [(lay + ("norm1", "scale"), (d,), "norm", NORM_STD),
                (lay + ("norm2", "scale"), (d,), "norm", NORM_STD),
                (lay + ("core", "wq"), (d, h * hd), "matrix", d ** -0.5),
                (lay + ("core", "wk"), (d, kv * hd), "matrix", d ** -0.5),
                (lay + ("core", "wv"), (d, kv * hd), "matrix", d ** -0.5),
                (lay + ("core", "wo"), (h * hd, d), "matrix",
                 (h * hd) ** -0.5),
                (lay + ("ffn", "w1"), (d, f), "matrix", d ** -0.5),
                (lay + ("ffn", "w3"), (d, f), "matrix", d ** -0.5),
                (lay + ("ffn", "w2"), (f, d), "matrix", f ** -0.5)]
        if model["qkv_bias"]:
            out += [(lay + ("core", "b" + n), (w,), "bias", BIAS_STD)
                    for n, w in (("q", h * hd), ("k", kv * hd),
                                 ("v", kv * hd))]
    return out


def n_values(model: dict) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in leaves(model))


def torch_seed(seed: int) -> int:
    """Any whole number as a generator seed (64 bits)."""
    return int(seed) % (1 << 64)


def make_params(model: dict, seed: int, device) -> dict:
    dtype = getattr(torch, model["dtype"])
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed))
    flat = torch.randn(n_values(model), generator=gen, device=device,
                       dtype=dtype)
    tree: dict = {"embed": {}, "final_norm": {},
                  "layers": [{"norm1": {}, "norm2": {}, "core": {}, "ffn": {}}
                             for _ in range(model["n_layers"])]}
    at = 0
    for path, shape, kind, scale in leaves(model):
        n = math.prod(shape)
        leaf = flat[at:at + n].view(shape)
        at += n
        leaf.mul_(scale)
        if kind == "norm":
            leaf.add_(1.0)
        node = tree
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = leaf
    return tree
