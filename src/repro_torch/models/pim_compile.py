"""Per-site PIM plan compiler (the paper's Algorithm 1, per site).

Port of ``repro.models.pim_compile``: one *projection site* per
weight-static matmul and pattern position, with one instance per repeat
— per (repeat, expert) on a MoE FFN — plus the LM head. An attention
layer's sites are ``wq wk wv wo``, a mamba layer's ``in_proj x_proj
out_proj``, each followed by its FFN's ``w1 w3 w2``; an rwkv layer has
none (its time- and channel-mix stay float, as in the reference), so on an
rwkv model only the head reaches the crossbar. Every model the port runs
compiles, an embeddings-mode one (hubert) from calibration embeddings.
Sites compile in three steps:

1. *capture* — an eager float forward over the calibration inputs with
   ``PimTap`` recorders standing in for plan leaves, so each site is
   calibrated on exactly the activations the real forward feeds it (an
   expert on its dispatch buffer, zero rows included);
2. *plan* — with ``cfg.pim_weight_slicing == "adaptive"``,
   ``core.adaptive.find_best_slicing`` runs per instance on
   ``SEARCH_ROWS`` calibration rows under the search ADC
   (``cfg.pim_search_adc_bits``), through the static-slicing crossbar
   (kernel K1), with the conservative 1b-per-slice override for the LM
   head; a tuple pins every site to that slicing. An expert that no
   calibration token reached has an all-zero buffer: its ``x_scale``
   sits at the 1e-12 floor and every candidate measures error 0, so it
   takes the first two-slice candidate, as in the reference;
3. *prepare* — for ``fast``/``int8``, ``calibrate_layer`` +
   ``quantize_weights_centered`` per instance; for ``exact``, the
   instances of a site are grouped by chosen slicing and each group is
   folded into the column axis of ``co.encode`` calls of at most
   ``FOLD_ELEMENTS`` weights (Eq. 2 centers are per column, so this is
   exact); planes are padded to the site's max slice count with
   ``slice_shifts`` / ``slice_valid`` tables — zero planes past each
   instance's slice count.

Everything runs on the params' device. Plans come out as ``{"layers":
[{"core": {...}, "ffn": {...}}, ...], "head": leaf}``, None for an rwkv
layer; leaf keys match the reference's, and an expert site's leaves carry
a leading expert axis. ``CompiledPim.specs`` holds the plans' logical
sharding axes (``plan_specs``; one layer's for ``compile_layer``), built
from ``transformer.layer_param_specs``. ``CompiledPim.report`` prices every site with
the §2.5 energy model (``core.energy``): converts/MAC, ADC energy share,
the slice-count histogram, as the reference's does, value for value.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import adaptive as ad
from repro_torch.core import adc as adc_lib
from repro_torch.core import center_offset as co
from repro_torch.core import energy as en
from repro_torch.core import mapping as mp
from repro_torch.core import slicing as slc
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.quant import quantize as q

_CORE_PROJ = {"attn": ("wq", "wk", "wv", "wo"),
              "mamba": ("in_proj", "x_proj", "out_proj")}
_FFN_PROJ = ("w1", "w3", "w2")

SEARCH_ROWS = 16  # calibration rows fed to Algorithm 1 (paper: ~10 inputs)
# most weights folded into one ``co.encode`` call (its int64 temporaries
# take ~24 B a weight): 26 M-weight experts fold five at a time
FOLD_ELEMENTS = 1 << 27
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
    """Plan tree + the per-site table, the config they compiled for, and
    the plans' logical sharding axes (``plan_specs``)."""
    cfg: ArchConfig
    plans: dict
    sites: tuple[SitePlan, ...]
    specs: dict | None = None

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

    def report(self, tokens: int = 4096) -> dict:
        """Price every site with the §2.5 energy model (JSON-serializable).

        Each site is mapped onto RAELLA silicon with *its own* slice count
        (``bits_per_weight_slice = 8 / n_slices``); speculation follows
        ``cfg.pim_speculation``. Reported per site: converts/MAC, ADC
        energy, total energy, ADC share — plus whole-model aggregates and
        the slice-count histogram (the paper's Fig. 7 x Fig. 12 story).
        """
        spec = 3 if self.cfg.pim_speculation else 0
        rows = []
        tot_converts = tot_macs = 0.0
        tot_adc = tot_energy = 0.0
        for sp in self.sites:
            shape = mp.LayerShape(
                name=sp.site, filter_len=sp.d_in, n_filters=sp.d_out,
                n_positions=tokens, signed_inputs=True,
                last_layer=sp.last_layer, row_positions=tokens)
            arch = dataclasses.replace(
                en.RAELLA, name=f"raella-{sp.n_slices}s",
                n_weight_slices=sp.n_slices,
                bits_per_weight_slice=slc.WEIGHT_BITS / sp.n_slices,
                spec_slices=spec, adaptive_slicing=False)
            r = en.analyze_layer(arch, shape)
            rows.append({
                "site": sp.site,
                "slicing": list(sp.slicing),
                "n_slices": sp.n_slices,
                "error": None if sp.error is None else round(sp.error, 4),
                "converts_per_mac": round(r.converts_per_mac, 4),
                "adc_energy_pj": round(r.e_adc, 1),
                "energy_pj": round(r.energy, 1),
                "adc_share": round(r.e_adc / r.energy, 3),
            })
            tot_converts += r.converts
            tot_macs += shape.macs
            tot_adc += r.e_adc
            tot_energy += r.energy
        return {
            "arch": self.cfg.name,
            "pim_mode": self.cfg.pim_mode,
            "slicing": ("adaptive"
                        if self.cfg.pim_weight_slicing == "adaptive"
                        else list(self.cfg.pim_weight_slicing)),
            "n_sites": len(self.sites),
            "distinct_slicings": ["-".join(map(str, s))
                                  for s in self.distinct_slicings()],
            "slice_histogram": {str(k): v
                                for k, v in self.slice_histogram().items()},
            "converts_per_mac": round(tot_converts / max(tot_macs, 1), 4),
            "adc_energy_share": round(tot_adc / max(tot_energy, 1e-9), 3),
            "energy_uj": round(tot_energy / 1e6, 2),
            "sites": rows,
        }


# ------------------------------------------------------------------ capture
def _block_projections(cfg: ArchConfig, i: int) -> dict | None:
    """Weight-static projection names of pattern position ``i``, by param
    group, or None for rwkv (its time- and channel-mix stay float, as in
    the reference)."""
    kind = cfg.block_pattern[i]
    if kind not in _CORE_PROJ:
        return None
    return {"core": _CORE_PROJ[kind], "ffn": _FFN_PROJ}


def _capture(params: dict, cfg: ArchConfig, calib: torch.Tensor,
             taps: dict) -> None:
    """Float forward that feeds every tap its projection inputs."""
    x = T.embed_inputs(params, cfg, calib)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device).expand(B, S)
    for layer, (bp, tap) in enumerate(zip(params["layers"], taps["layers"])):
        x = T.apply_block(bp, cfg, layer, x, positions, plan=tap)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    L.lm_head(params["embed"], cfg, x, plan=taps["head"])


# ------------------------------------------------------------------ slicing
def _site_slicings(ws: list, xs: list, cfg: ArchConfig,
                   last_layer: bool) -> tuple[list, list]:
    """Per-instance (slicing, error) for one site's instances.

    ws: K weights (d_in, d_out); xs: K calibration inputs (N, d_in).
    Adaptive mode runs Algorithm 1 per instance on the first
    ``SEARCH_ROWS`` calibration rows under the search ADC; tuple mode pins
    every instance (error None — nothing was measured).
    """
    K = len(ws)
    if cfg.pim_weight_slicing != "adaptive":
        return [tuple(cfg.pim_weight_slicing)] * K, [None] * K
    adc = adc_lib.ADCConfig(bits=cfg.pim_search_adc_bits, signed=True)
    slicings, errors = [], []
    for w, x in zip(ws, xs):
        choice = ad.find_best_slicing(w.to(torch.float32), x[:SEARCH_ROWS],
                                      adc=adc, last_layer=last_layer)
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
    lq, w_q = q.calibrate_layer(w.to(torch.float32), x_cal,
                                signed_inputs=True)
    return {"w_q": w_q, "w_scale": lq.w_scale, "x_scale": lq.x_scale}


def _stack(dicts: list[dict]) -> dict:
    return {k: torch.stack([d[k] for d in dicts]) for k in dicts[0]}


def _exact_prepare_stacked(ws: list, xs: list, slicings: list) -> dict:
    """Exact-mode leaves for one site's K instances.

    ws: K weights (R, C); xs: K calibration inputs (N, R). Instances are
    grouped by slicing; each group is Center+Offset encoded with its
    instances folded into the column axis, in folds of at most
    ``FOLD_ELEMENTS`` weights (Eq. 2 centers are per column, so any
    grouping gives the reference's one-call fold bit for bit), then planes
    are padded to the site's max slice count with ``slice_valid`` masks
    and ``slice_shifts``.
    """
    K = len(ws)
    R, C = ws[0].shape
    qd = _stack([_ref_quant_2d(w, x) for w, x in zip(ws, xs)])
    n_max = max(len(s) for s in slicings)
    rx = co.ROWS_PER_CROSSBAR
    n_seg = -(-R // rx)
    dev = ws[0].device
    planes = torch.zeros((K, n_max, n_seg, rx, C), dtype=torch.int8,
                         device=dev)
    centers = torch.zeros((K, n_seg, C), dtype=torch.int32, device=dev)
    shifts = torch.zeros((K, n_max), dtype=torch.int32, device=dev)
    valid = torch.zeros((K, n_max), dtype=torch.bool, device=dev)
    groups: dict[tuple, list[int]] = {}
    for k, s in enumerate(slicings):
        groups.setdefault(tuple(s), []).append(k)
    per_fold = max(1, FOLD_ELEMENTS // (R * C))
    for s, members in groups.items():
        n_s = len(s)
        for f0 in range(0, len(members), per_fold):
            ks = members[f0:f0 + per_fold]
            kg = len(ks)
            # unsigned crossbar domain
            w_u = qd["w_q"][ks].to(torch.int64) + 128
            folded = w_u.permute(1, 0, 2).reshape(R, kg * C)
            del w_u
            enc = co.encode(folded, s)
            del folded
            pl = enc.planes.reshape(n_s, n_seg, rx, kg, C)
            ce = enc.centers.reshape(n_seg, kg, C)
            for j, k in enumerate(ks):
                planes[k, :n_s] = pl[:, :, :, j]
                centers[k] = ce[:, j]
                shifts[k, :n_s] = torch.tensor(enc.shifts, dtype=torch.int32)
                valid[k, :n_s] = True
            del enc, pl, ce
    return {"planes": planes, "enc_centers": centers, "slice_shifts": shifts,
            "slice_valid": valid, "w_q": qd["w_q"],
            "w_scale": qd["w_scale"], "x_scale": qd["x_scale"]}


def _compile_site(name: str, ws: list, xs: list, cfg: ArchConfig,
                  last_layer: bool = False, tags: list | None = None
                  ) -> tuple[dict, list[SitePlan]]:
    """Compile one projection site over its instances: ``ws`` (d_in, d_out)
    weights and ``xs`` (N, d_in) calibration inputs, one per instance,
    named ``name + tags[k]`` (default ``[r{k}]``; the LM head has one
    instance and no tag). Weights are taken to float32 one instance at a
    time. Returns the leaf stacked over instances and the site table."""
    K = len(ws)
    d_in, d_out = ws[0].shape
    if tags is None:
        tags = [""] if last_layer else [f"[r{k}]" for k in range(K)]
    slicings, errors = _site_slicings(ws, xs, cfg, last_layer)
    sites = [SitePlan(site=name + tag, d_in=d_in, d_out=d_out,
                      slicing=tuple(s), error=e,
                      search_adc_bits=cfg.pim_search_adc_bits,
                      last_layer=last_layer)
             for tag, s, e in zip(tags, slicings, errors)]
    if cfg.pim_mode in ("fast", "int8"):
        leaf = _stack([_fast_prepare_2d(w, x) for w, x in zip(ws, xs)])
    else:
        leaf = _exact_prepare_stacked(ws, xs, slicings)
    return leaf, sites


# ------------------------------------------------------------------ compile
def _taps(paths: dict) -> dict:
    return {g: {n: L.PimTap() for n in names} for g, names in paths.items()}


def _compile_position(bps: list, taps: list, cfg: ArchConfig,
                      i: int) -> tuple[list, list[SitePlan]]:
    """Compile pattern position ``i``'s sites over its layers ``bps`` (its
    repeats, in order) from their filled ``taps``: one instance per layer,
    per (layer, expert) on a MoE FFN. Returns one plan dict per layer."""
    paths, E = _block_projections(cfg, i), cfg.n_experts
    plans = [{g: {} for g in paths} for _ in bps]
    sites: list[SitePlan] = []
    for g, names in paths.items():
        expert = g == "ffn" and L.is_moe_layer(cfg, i)
        for name in names:
            ws = [bp[g][name] for bp in bps]
            xs = [t[g][name].x[0] for t in taps]
            tags = [f"[r{r}]" for r in range(len(bps))]
            if expert:  # (E, ...) per layer -> one per expert
                ws = [w[e] for w in ws for e in range(E)]
                xs = [x[e] for x in xs for e in range(E)]
                tags = [f"[r{r},e{e}]" for r in range(len(bps))
                        for e in range(E)]
            leaf, leaf_sites = _compile_site(f"blocks[{i}].{g}.{name}", ws,
                                             xs, cfg, tags=tags)
            for r, plan in enumerate(plans):
                at = slice(r * E, (r + 1) * E) if expert else r
                plan[g][name] = {k: v[at] for k, v in leaf.items()}
            sites.extend(leaf_sites)
    return plans, sites


def compile_pim_params(params: dict, cfg: ArchConfig,
                       calib_tokens) -> CompiledPim | None:
    """Compile ``params`` into per-site PIM plans for ``cfg.pim_mode``.

    calib_tokens: (B, S) token ids, or (B, S, D) frame embeddings for an
    embeddings-mode config (numpy or tensor), for the activation
    calibration and Algorithm 1's search rows. Mode 'off' returns None —
    the float path needs no compile.
    Sites are per pattern position ``i``, as in the reference: a dense
    site has one instance per repeat (``blocks[i].core.wq[r1]``), an
    expert site one per (repeat, expert) (``blocks[i].ffn.w1[r1,e3]``),
    each with its own Algorithm 1 decision on its own calibration rows —
    an expert's dispatch buffer, zero rows included.
    """
    if cfg.pim_mode == "off":
        return None
    if cfg.pim_mode not in ("fast", "exact", "int8"):
        raise ValueError(f"unknown pim_mode {cfg.pim_mode!r}")
    dev = params["embed"]["embed"].device
    calib = torch.as_tensor(calib_tokens, device=dev)
    if cfg.input_mode == "tokens":
        calib = calib.to(torch.int64)
    n_pat = len(cfg.block_pattern)
    paths = [_block_projections(cfg, layer % n_pat)
             for layer in range(cfg.n_layers)]
    taps = {"head": L.PimTap(),
            "layers": [None if p is None else _taps(p) for p in paths]}
    layer_plans = [None] * cfg.n_layers
    sites: list[SitePlan] = []
    with torch.no_grad():
        _capture(params, cfg, calib, taps)
        for i in range(n_pat):
            if paths[i] is None:
                continue
            layers = range(i, cfg.n_layers, n_pat)  # repeat r: r*n_pat + i
            plans, pos_sites = _compile_position(
                [params["layers"][l] for l in layers],
                [taps["layers"][l] for l in layers], cfg, i)
            for l, plan in zip(layers, plans):
                layer_plans[l] = plan
            sites.extend(pos_sites)
        head, head_sites = _compile_site(
            "embed.head", [params["embed"]["head"]], [taps["head"].x[0]],
            cfg, last_layer=True)
    sites.extend(head_sites)
    plans = {"layers": layer_plans,
             "head": {k: v[0] for k, v in head.items()}}
    return CompiledPim(cfg=cfg, plans=plans, sites=tuple(sites),
                       specs=plan_specs(cfg))


def compile_layer(bp: dict, cfg: ArchConfig, layer: int,
                  x_cal: torch.Tensor) -> CompiledPim | None:
    """Plans of one layer alone, for a model that does not fit the card
    whole: ``x_cal`` (B, S, d_model) stands for the layer's input
    activations, ``apply_block`` feeds the taps, and each site compiles as
    in ``compile_pim_params`` (one instance, named ``[r0]``; one per
    expert on a MoE FFN). Returns the layer's plan dict as
    ``CompiledPim.plans``, None for an rwkv layer or mode 'off'."""
    paths = _block_projections(cfg, layer % len(cfg.block_pattern))
    if cfg.pim_mode == "off" or paths is None:
        return None
    taps = _taps(paths)
    B, S = x_cal.shape[0], x_cal.shape[1]
    positions = torch.arange(S, device=x_cal.device).expand(B, S)
    with torch.no_grad():
        T.apply_block(bp, cfg, layer, x_cal, positions, plan=taps)
        plans, sites = _compile_position(
            [bp], [taps], cfg, layer % len(cfg.block_pattern))
    return CompiledPim(cfg=cfg, plans=plans[0], sites=tuple(sites),
                       specs=layer_plan_specs(cfg, layer))


# ------------------------------------------------------------------ specs
def _site_specs(ws: tuple, mode: str) -> dict:
    """Plan-leaf logical axes derived from one weight's spec tuple.

    ``ws`` ends with (in_axis, out_axis); a leading entry is the expert
    axis of a MoE site. The int8 offset planes keep the float weight's
    layout; per-column terms keep the output axis; the per-site slice
    tables (shifts/validity masks) are replicated along the padded slice
    axis.
    """
    lead, out_ax = ws[:-2], ws[-1]
    common = {"w_q": ws, "w_scale": lead + (out_ax,), "x_scale": lead}
    if mode in ("fast", "int8"):
        return dict(common, w_off=ws, centers=lead + (out_ax,),
                    scale=lead + (out_ax,))
    # exact: planes (n_slices, n_seg, rows_per_xbar, cols) per instance
    return dict(common, planes=lead + (None, None, None, out_ax),
                enc_centers=lead + (None, out_ax),
                slice_shifts=lead + (None,),
                slice_valid=lead + (None,))


def layer_plan_specs(cfg: ArchConfig, layer: int) -> dict | None:
    """Logical axes of layer ``layer``'s plan dict (None for an rwkv layer
    or mode 'off')."""
    paths = _block_projections(cfg, layer % len(cfg.block_pattern))
    if cfg.pim_mode == "off" or paths is None:
        return None
    ps = T.layer_param_specs(cfg, layer)
    return {g: {n: _site_specs(ps[g][n], cfg.pim_mode) for n in names}
            for g, names in paths.items()}


def plan_specs(cfg: ArchConfig) -> dict | None:
    """Logical sharding axes mirroring ``compile_pim_params``'s plans:
    ``{"layers": [...], "head": ...}``, None in mode 'off'."""
    if cfg.pim_mode == "off":
        return None
    return {"layers": [layer_plan_specs(cfg, layer)
                       for layer in range(cfg.n_layers)],
            "head": _site_specs(T.param_specs(cfg)["embed"]["head"],
                                cfg.pim_mode)}
