"""Shared setup of the model-level parity tests (``test_torch_model_*``):
one reduced float32 config of an arch in both packages, the reference's
weights carried across, and compiled plans from the same numpy tokens."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as ref_configs
from repro.models import pim_compile as ref_pc
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.models import convert
from repro_torch.models import pim_compile as pc
from repro_torch.models import transformer as T

MODES = ("off", "fast", "int8", "exact")
PROJ = {"core": ("wq", "wk", "wv", "wo"), "ffn": ("w1", "w3", "w2")}
PROMPT, TOTAL = 6, 10   # prefill 6 tokens, then 4 teacher-forced decodes
# Logit tolerances. 'off' differs only by float32 reassociation (rmsnorm,
# softmax, rope and matmul sum orders): ~1e-6 at these widths. The PIM
# modes add the 8b input codes: a 1-ulp activation difference at a
# rounding boundary flips one code, which moves a logit by up to about
# x_scale * w_scale * 127 ~ 1e-2 here.
ATOL = {"off": 1e-4, "fast": 1e-2, "int8": 1e-2, "exact": 1e-2}


@functools.lru_cache(maxsize=None)
def setup(arch: str):
    over = dict(dtype="float32", kv_cache_dtype="float32")
    rcfg = ref_configs.get(arch).reduced(**over)
    cfg = configs.get(arch).reduced(**over)
    rparams, _ = RT.init_params(rcfg, jax.random.key(0))
    np_params = jax.tree.map(lambda a: np.array(a, np.float32), rparams)
    params = convert.params_from_reference(np_params, cfg, "cpu")
    calib = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, TOTAL)).astype(np.int32)
    return rcfg, cfg, rparams, np_params, params, calib, tokens


@functools.lru_cache(maxsize=None)
def compiled(arch: str, mode: str):
    """(reference plans, port plans) for ``mode``."""
    rcfg, cfg, rparams, _, params, calib, _ = setup(arch)
    if mode == "off":
        return None, None
    rc = dataclasses.replace(rcfg, pim_mode=mode)
    c = dataclasses.replace(cfg, pim_mode=mode)
    return (ref_pc.compile_pim_params(rparams, rc, calib).plans,
            pc.compile_pim_params(params, c, calib).plans)


def run_ref(rcfg, rparams, plans, tokens) -> np.ndarray:
    """Reference full-sequence forward logits (B, TOTAL, vocab)."""
    fwd = jax.jit(lambda p, pl, t: RT.forward(p, rcfg, t, plans=pl))
    return np.asarray(fwd(rparams, plans, jnp.asarray(tokens)))


def run_port(cfg, params, plans, tokens) -> np.ndarray:
    """Port logits of positions PROMPT-1 .. TOTAL-1: prefill over the
    prompt, then teacher-forced decode steps."""
    toks = torch.from_numpy(tokens).long()
    with torch.no_grad():
        lg, st = T.prefill(params, cfg, toks[:, :PROMPT], max_len=TOTAL,
                           plans=plans)
        out = [lg]
        for t in range(PROMPT, TOTAL):
            lg, st = T.decode_step(params, cfg, st, toks[:, t:t + 1],
                                   plans=plans)
            out.append(lg)
    return torch.cat(out, dim=1).numpy()


def ref_logits(arch: str, mode: str) -> np.ndarray:
    rcfg, _, rparams, _, _, _, tokens = setup(arch)
    return run_ref(dataclasses.replace(rcfg, pim_mode=mode), rparams,
                   compiled(arch, mode)[0], tokens)


def port_logits(arch: str, mode: str) -> np.ndarray:
    _, cfg, _, _, params, _, tokens = setup(arch)
    return run_port(dataclasses.replace(cfg, pim_mode=mode), params,
                    compiled(arch, mode)[1], tokens)


def assert_logits_close(got: np.ndarray, ref: np.ndarray,
                        mode: str) -> None:
    """Within ``ATOL[mode]``, argmax equal wherever the reference's top-2
    margin exceeds twice that. ``ref`` covers all TOTAL positions."""
    ref = ref[:, PROMPT - 1:]
    np.testing.assert_allclose(got, ref, atol=ATOL[mode], rtol=0)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * ATOL[mode]
    assert clear.any()
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  ref.argmax(-1)[clear])


def check_logits(arch: str, mode: str) -> np.ndarray:
    """Hold the port's logits to the reference's; return the port's."""
    got = port_logits(arch, mode)
    assert_logits_close(got, ref_logits(arch, mode), mode)
    return got


def check_plans(arch: str, mode: str) -> None:
    """Plan leaves against the reference's.

    From the same calibration tokens every weight-derived leaf is equal
    bit for bit; ``x_scale`` (max |activation| / 127) comes from each
    framework's own float forward and agrees to a few ulp. Fed the
    reference's captured activations, the port's site compiler reproduces
    every leaf — ``x_scale`` included — bit for bit.
    """
    rcfg, cfg, rparams, np_params, params, calib, _ = setup(arch)
    ref, port = compiled(arch, mode)
    n = cfg.n_layers
    pairs = [(port["head"], {k: np.asarray(v)
                             for k, v in ref["embed"]["head"].items()})]
    for g, names in PROJ.items():
        for name in names:
            for layer in range(n):
                pairs.append((port["layers"][layer][g][name],
                              {k: np.asarray(v)[layer] for k, v in
                               ref["blocks"][0][g][name].items()}))
    for got, want in pairs:
        assert set(got) == set(want)
        for k in got:
            if k == "x_scale":
                np.testing.assert_allclose(got[k].numpy(), want[k],
                                           rtol=5e-7)
            else:
                np.testing.assert_array_equal(got[k].numpy(), want[k])
    # the site compiler on the reference's own captured activations
    rc = dataclasses.replace(rcfg, pim_mode=mode)
    c = dataclasses.replace(cfg, pim_mode=mode)
    taps = ref_pc._build_taps(rc)
    ref_pc._capture(rparams, rc, calib, taps)
    for g, names in PROJ.items():
        for name in names:
            leaf, _ = pc._compile_site(
                name, [torch.from_numpy(np_params["blocks"][0][g][name][r])
                       for r in range(n)],
                [torch.tensor(x) for x in taps["blocks"][0][g][name].x],
                c)
            for k, v in leaf.items():
                np.testing.assert_array_equal(
                    v.numpy(), np.asarray(ref["blocks"][0][g][name][k]))
    leaf, _ = pc._compile_site(
        "embed.head", [torch.from_numpy(np_params["embed"]["head"])],
        [torch.tensor(taps["embed"]["head"].x[0])], c, last_layer=True)
    for k, v in leaf.items():
        np.testing.assert_array_equal(v[0].numpy(),
                                      np.asarray(ref["embed"]["head"][k]))
