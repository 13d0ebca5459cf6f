"""Per-site PIM plan compiler (the paper's Algorithm 1, per site).

Port of ``repro.models.pim_compile``: one *projection site* per
weight-static matmul (per layer, plus the LM head), compiled in three
steps:

1. *capture* — an eager float forward over the calibration tokens with
   ``PimTap`` recorders standing in for plan leaves, so each site is
   calibrated on exactly the activations the real forward feeds it;
2. *plan* — with ``cfg.pim_weight_slicing == "adaptive"``,
   ``core.adaptive.find_best_slicing`` runs per instance on
   ``SEARCH_ROWS`` calibration rows under the search ADC
   (``cfg.pim_search_adc_bits``), through the static-slicing crossbar
   (kernel K1), with the conservative 1b-per-slice override for the LM
   head; a tuple pins every site to that slicing;
3. *prepare* — for ``fast``/``int8``, ``calibrate_layer`` +
   ``quantize_weights_centered`` per instance; for ``exact``, the
   instances of a site are grouped by chosen slicing and each group is
   folded into the column axis of ONE ``co.encode`` call (Eq. 2 centers
   are per column, so this is exact); planes are padded to the site's max
   slice count with ``slice_shifts`` / ``slice_valid`` tables — zero
   planes past each instance's slice count.

Everything runs on the params' device. Plans come out as ``{"layers":
[{"core": {...}, "ffn": {...}}, ...], "head": leaf}``; leaf keys match the
reference's. The reference's energy report (``CompiledPim.report``) needs
``core.energy`` and ``core.mapping``, which are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import adaptive as ad
from repro_torch.core import adc as adc_lib
from repro_torch.core import center_offset as co
from repro_torch.core import slicing as slc
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.quant import quantize as q

_PROJ = {"core": ("wq", "wk", "wv", "wo"), "ffn": ("w1", "w3", "w2")}

SEARCH_ROWS = 16  # calibration rows fed to Algorithm 1 (paper: ~10 inputs)
CONSERVATIVE_SLICING = (1,) * slc.WEIGHT_BITS


@dataclasses.dataclass(frozen=True)
class SitePlan:
    """One projection-site instance's compiled decision."""
    site: str                  # e.g. "blocks[0].core.wq[r1]", "embed.head"
    d_in: int
    d_out: int
    slicing: tuple[int, ...]
    error: float | None        # measured §4.2.1 error (None: pinned slicing)
    search_adc_bits: int
    last_layer: bool = False

    @property
    def n_slices(self) -> int:
        return len(self.slicing)


@dataclasses.dataclass
class CompiledPim:
    """Plan tree + the per-site table."""
    plans: dict
    sites: tuple[SitePlan, ...]

    def site(self, name: str) -> SitePlan:
        for s in self.sites:
            if s.site == name:
                return s
        raise KeyError(name)

    def distinct_slicings(self) -> tuple[tuple[int, ...], ...]:
        return tuple(sorted({s.slicing for s in self.sites}))

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


# ------------------------------------------------------------------ slicing
def _site_slicings(wf: torch.Tensor, xf: torch.Tensor, cfg: ArchConfig,
                   last_layer: bool) -> tuple[list, list]:
    """Per-instance (slicing, error) for one site's stack.

    wf: (K, d_in, d_out); xf: (K, N, d_in). Adaptive mode runs Algorithm 1
    per instance on the first ``SEARCH_ROWS`` calibration rows under the
    search ADC; tuple mode pins every instance (error None — nothing was
    measured).
    """
    K = wf.shape[0]
    if cfg.pim_weight_slicing != "adaptive":
        return [tuple(cfg.pim_weight_slicing)] * K, [None] * K
    adc = adc_lib.ADCConfig(bits=cfg.pim_search_adc_bits, signed=True)
    slicings, errors = [], []
    for k in range(K):
        choice = ad.find_best_slicing(wf[k], xf[k][:SEARCH_ROWS], adc=adc,
                                      last_layer=last_layer)
        slicings.append(choice.slicing)
        errors.append(choice.error)
    return slicings, errors


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
    slicings, errors = _site_slicings(wf, xf, cfg, last_layer)
    tags = [f"[r{k}]" for k in range(K)] if not last_layer else [""]
    sites = [SitePlan(site=name + tag, d_in=d_in, d_out=d_out,
                      slicing=tuple(s), error=e,
                      search_adc_bits=cfg.pim_search_adc_bits,
                      last_layer=last_layer)
             for tag, s, e in zip(tags, slicings, errors)]
    if cfg.pim_mode in ("fast", "int8"):
        leaf = _stack([_fast_prepare_2d(wf[k], xf[k]) for k in range(K)])
    else:
        leaf = _exact_prepare_stacked(wf, xf, slicings)
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
