"""Per-site PIM plan compiler for pinned weight slicings.

Port of ``repro.models.pim_compile`` without Algorithm 1: one *projection
site* per weight-static matmul (per layer, plus the LM head), compiled in
three steps:

1. *capture* — an eager float forward over the calibration tokens with
   ``PimTap`` recorders standing in for plan leaves, so each site is
   calibrated on exactly the activations the real forward feeds it;
2. *plan* — every site takes the pinned ``cfg.pim_weight_slicing``
   (``"adaptive"`` — Algorithm 1 — raises ``NotImplementedError``);
3. *prepare* — for ``fast``/``int8``, ``calibrate_layer`` +
   ``quantize_weights_centered`` per instance; for ``exact``, the layers of
   a site are folded into the column axis of ONE ``co.encode`` call (Eq. 2
   centers are per column, so this is exact) and the planes are laid out
   with ``slice_shifts`` / ``slice_valid`` tables like the reference's
   ragged per-site plans — zero planes past each instance's slice count.

Everything runs on the params' device, so the full-width compile takes
seconds on the card. Plans come out as ``{"layers": [{"core": {...},
"ffn": {...}}, ...], "head": leaf}``; leaf keys match the reference's.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import center_offset as co
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.quant import quantize as q

_PROJ = {"core": ("wq", "wk", "wv", "wo"), "ffn": ("w1", "w3", "w2")}


@dataclasses.dataclass(frozen=True)
class SitePlan:
    """One projection-site instance's compiled decision."""
    site: str                  # e.g. "blocks[0].core.wq[r1]", "embed.head"
    d_in: int
    d_out: int
    slicing: tuple[int, ...]
    last_layer: bool = False

    @property
    def n_slices(self) -> int:
        return len(self.slicing)


@dataclasses.dataclass
class CompiledPim:
    """Plan tree + the per-site table."""
    plans: dict
    sites: tuple[SitePlan, ...]

    def slice_histogram(self) -> dict[int, int]:
        hist: dict[int, int] = {}
        for s in self.sites:
            hist[s.n_slices] = hist.get(s.n_slices, 0) + 1
        return dict(sorted(hist.items()))


# ------------------------------------------------------------------ capture
def _capture(params: dict, cfg: ArchConfig, calib_tokens: torch.Tensor,
             taps: dict) -> None:
    """Float forward that feeds every tap its projection inputs."""
    x = T.embed_inputs(params, cfg, calib_tokens)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device).expand(B, S)
    for bp, tap in zip(params["layers"], taps["layers"]):
        x = T.apply_block(bp, cfg, x, positions, plan=tap)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    L.lm_head(params["embed"], cfg, x, plan=taps["head"])


# ------------------------------------------------------------------ prepare
def _fast_prepare_2d(w: torch.Tensor, x_cal: torch.Tensor) -> dict:
    """One layer's fast/int8 plan: symmetric per-channel int8 (the
    reference quantizer) + centered asymmetric int8 (Eq. 1 operands)."""
    w = w.to(torch.float32)
    lq, w_q = q.calibrate_layer(w, x_cal, signed_inputs=True)
    w_off, centers, scale = q.quantize_weights_centered(w)
    return {"w_off": w_off, "centers": centers, "scale": scale,
            "w_q": w_q, "w_scale": lq.w_scale, "x_scale": lq.x_scale}


def _ref_quant_2d(w: torch.Tensor, x_cal: torch.Tensor) -> dict:
    """Exact-mode reference quantization of one layer."""
    lq, w_q = q.calibrate_layer(w, x_cal, signed_inputs=True)
    return {"w_q": w_q, "w_scale": lq.w_scale, "x_scale": lq.x_scale}


def _stack(dicts: list[dict]) -> dict:
    return {k: torch.stack([d[k] for d in dicts]) for k in dicts[0]}


def _exact_prepare_stacked(wf: torch.Tensor, xf: torch.Tensor,
                           slicings: list) -> dict:
    """Exact-mode leaves for one site's stack of K instances.

    wf: (K, R, C) float; xf: (K, N, R). Instances are grouped by slicing;
    each group's Center+Offset encode folds the group into the column axis,
    then planes are padded to the site's max slice count with
    ``slice_valid`` masks and ``slice_shifts``.
    """
    K, R, C = wf.shape
    qd = _stack([_ref_quant_2d(wf[k], xf[k]) for k in range(K)])
    w_u = qd["w_q"].to(torch.int64) + 128  # unsigned crossbar domain
    n_max = max(len(s) for s in slicings)
    rx = co.ROWS_PER_CROSSBAR
    n_seg = -(-R // rx)
    dev = wf.device
    planes = torch.zeros((K, n_max, n_seg, rx, C), dtype=torch.int8,
                         device=dev)
    centers = torch.zeros((K, n_seg, C), dtype=torch.int32, device=dev)
    shifts = torch.zeros((K, n_max), dtype=torch.int32, device=dev)
    valid = torch.zeros((K, n_max), dtype=torch.bool, device=dev)
    groups: dict[tuple, list[int]] = {}
    for k, s in enumerate(slicings):
        groups.setdefault(tuple(s), []).append(k)
    for s, ks in groups.items():
        kg, n_s = len(ks), len(s)
        folded = w_u[ks].permute(1, 0, 2).reshape(R, kg * C)
        enc = co.encode(folded, s)
        pl = enc.planes.reshape(n_s, n_seg, rx, kg, C)
        ce = enc.centers.reshape(n_seg, kg, C)
        for j, k in enumerate(ks):
            planes[k, :n_s] = pl[:, :, :, j]
            centers[k] = ce[:, j]
            shifts[k, :n_s] = torch.tensor(enc.shifts, dtype=torch.int32)
            valid[k, :n_s] = True
        del folded, enc, pl
    return {"planes": planes, "enc_centers": centers, "slice_shifts": shifts,
            "slice_valid": valid, "w_q": qd["w_q"],
            "w_scale": qd["w_scale"], "x_scale": qd["x_scale"]}


def _compile_site(name: str, ws: list[torch.Tensor], xs: list[torch.Tensor],
                  cfg: ArchConfig, last_layer: bool = False
                  ) -> tuple[dict, list[SitePlan]]:
    """Compile one projection site over its instances (one per layer, or
    the single LM head). Returns the stacked leaf and the site table."""
    wf = torch.stack([w.to(torch.float32) for w in ws])
    xf = torch.stack(xs)
    K, d_in, d_out = wf.shape
    slicing = tuple(cfg.pim_weight_slicing)
    tags = [f"[r{k}]" for k in range(K)] if not last_layer else [""]
    sites = [SitePlan(site=name + tag, d_in=d_in, d_out=d_out,
                      slicing=slicing, last_layer=last_layer)
             for tag in tags]
    if cfg.pim_mode in ("fast", "int8"):
        leaf = _stack([_fast_prepare_2d(wf[k], xf[k]) for k in range(K)])
    else:
        leaf = _exact_prepare_stacked(wf, xf, [slicing] * K)
    return leaf, sites


# ------------------------------------------------------------------ compile
def compile_pim_params(params: dict, cfg: ArchConfig,
                       calib_tokens) -> CompiledPim | None:
    """Compile ``params`` into per-site PIM plans for ``cfg.pim_mode``.

    calib_tokens: (B, S) token ids (numpy or tensor) for the activation
    calibration. Mode 'off' returns None — the float path needs no compile.
    """
    if cfg.pim_mode == "off":
        return None
    if cfg.pim_mode not in ("fast", "exact", "int8"):
        raise ValueError(f"unknown pim_mode {cfg.pim_mode!r}")
    if cfg.pim_weight_slicing == "adaptive":
        raise NotImplementedError(
            "adaptive slicing (Algorithm 1, kernel K1) is not ported yet; "
            "pin a slicing such as (4, 2, 2)")
    dev = params["embed"]["embed"].device
    tokens = torch.as_tensor(calib_tokens, dtype=torch.int64, device=dev)
    taps = {"head": L.PimTap(),
            "layers": [{g: {n: L.PimTap() for n in names}
                        for g, names in _PROJ.items()}
                       for _ in range(cfg.n_layers)]}
    with torch.no_grad():
        _capture(params, cfg, tokens, taps)
        sites: list[SitePlan] = []
        layer_plans = [{g: {} for g in _PROJ} for _ in range(cfg.n_layers)]
        for g, names in _PROJ.items():
            for name in names:
                leaf, leaf_sites = _compile_site(
                    f"blocks[0].{g}.{name}",
                    [bp[g][name] for bp in params["layers"]],
                    [tap[g][name].x[0] for tap in taps["layers"]], cfg)
                for layer, lp in enumerate(layer_plans):
                    lp[g][name] = {k: v[layer] for k, v in leaf.items()}
                sites.extend(leaf_sites)
        head, head_sites = _compile_site(
            "embed.head", [params["embed"]["head"]], [taps["head"].x[0]],
            cfg, last_layer=True)
    sites.extend(head_sites)
    plans = {"layers": layer_plans,
             "head": {k: v[0] for k, v in head.items()}}
    return CompiledPim(plans=plans, sites=tuple(sites))
