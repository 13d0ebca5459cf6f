"""The port's analytic models against the reference's: the crossbar
mapping, the §2.5 energy model, the paper's workload tables, the LM zoo
bridge and ``CompiledPim.report``.

Everything here is plain Python arithmetic on ints and floats, so the
port's copies are held to the reference with ``==``: every workload table,
``analyze_dnn`` over every workload on ``ISAAC_8B``, ``RAELLA`` and
``RAELLA_NO_SPEC`` field for field, ``from_arch_config`` on all eleven
registered configs, and ``report()`` on one site table given to both
packages' ``CompiledPim``. (The reports of real compiles are held in
``test_torch_decoders.py``, pinned, and ``test_torch_adaptive.py``,
Algorithm 1's.) Then the reference's own checks of the model
(``test_core_energy.py``, ``test_lm_on_pim.py``) run on the port's copies.
"""

import dataclasses

import numpy as np
import pytest

from repro import configs as ref_configs
from repro.core import energy as ref_en
from repro.core import lm_workloads as ref_lm
from repro.core import mapping as ref_mp
from repro.core import workloads as ref_wl
from repro.models import pim_compile as ref_pc
from repro_torch import configs
from repro_torch.core import energy as en
from repro_torch.core import lm_workloads as lm
from repro_torch.core import mapping as mp
from repro_torch.core import workloads as wl
from repro_torch.models import pim_compile as pc

from _torch_parity import one_thread  # noqa: F401  (autouse fixture)

ARCHS = ("ISAAC_8B", "RAELLA", "RAELLA_NO_SPEC")
PRESETS = ARCHS + ("CENTER_OFFSET_ONLY", "CENTER_ADAPTIVE", "FORMS_8")
ASSIGNED = [n for n in configs.REGISTRY if n != "raella-bert-large"]


def _asdicts(xs) -> list[dict]:
    return [dataclasses.asdict(x) for x in xs]


def _dnn(rep) -> dict:
    """A ``DnnReport`` as plain values: every layer's fields and every
    whole-model property."""
    return {"arch": rep.arch, "layers": _asdicts(rep.layers),
            "energies": [l.energy for l in rep.layers],
            "energy": rep.energy, "macs": rep.macs,
            "converts_per_mac": rep.converts_per_mac,
            "latency_ns": rep.latency_ns,
            "energy_breakdown": rep.energy_breakdown}


# ------------------------------------------------------------ against the ref
def test_constants_and_presets_match_reference():
    names = [n for n in dir(ref_en) if n.isupper()]
    assert names == [n for n in dir(en) if n.isupper()]
    for n in names:
        want, got = getattr(ref_en, n), getattr(en, n)
        if dataclasses.is_dataclass(want):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), n
            assert got.total_crossbars == want.total_crossbars
            assert got.converts_per_column_pass() == \
                want.converts_per_column_pass()
            for signed in (False, True):
                assert got.cycles_per_psum_set(signed) == \
                    want.cycles_per_psum_set(signed)
        else:
            assert got == want, n
    assert [en.adc_energy_per_convert(b) for b in range(1, 13)] == \
        [ref_en.adc_energy_per_convert(b) for b in range(1, 13)]


@pytest.mark.parametrize("name", list(ref_wl.WORKLOADS))
def test_workload_tables_match_reference(name):
    assert list(wl.WORKLOADS) == list(ref_wl.WORKLOADS)
    assert _asdicts(wl.WORKLOADS[name]()) == \
        _asdicts(ref_wl.WORKLOADS[name]())
    if name == "bert_large":
        assert _asdicts(wl.bert_large_ffn(seq=64)) == \
            _asdicts(ref_wl.bert_large_ffn(seq=64))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", list(ref_wl.WORKLOADS))
def test_analyze_dnn_matches_reference(name, arch):
    got_layers, want_layers = wl.WORKLOADS[name](), ref_wl.WORKLOADS[name]()
    for replicate in (True, False):
        got = en.analyze_dnn(getattr(en, arch), got_layers, replicate)
        want = ref_en.analyze_dnn(getattr(ref_en, arch), want_layers,
                                  replicate)
        assert _dnn(got) == _dnn(want)


@pytest.mark.parametrize("arch", list(ref_configs.REGISTRY))
def test_from_arch_config_matches_reference(arch):
    assert set(configs.REGISTRY) == set(ref_configs.REGISTRY)
    cfg, rcfg = configs.get(arch), ref_configs.get(arch)
    for tokens in (64, 4096):
        got = lm.from_arch_config(cfg, tokens)
        assert _asdicts(got) == _asdicts(ref_lm.from_arch_config(rcfg, tokens))
    assert _dnn(en.analyze_dnn(en.RAELLA, got, replicate=False)) == \
        _dnn(ref_en.analyze_dnn(ref_en.RAELLA, ref_lm.from_arch_config(
            rcfg, 4096), replicate=False))


def test_mapping_and_work_pricing_match_reference():
    rng = np.random.default_rng(0)
    shapes = [(int(f), int(n), int(p), bool(d))
              for f, n, p, d in zip(rng.integers(1, 3000, 40),
                                    rng.integers(1, 600, 40),
                                    rng.integers(1, 500, 40),
                                    rng.integers(0, 2, 40))]
    got = [mp.LayerShape(f"l{i}", f, n, p, depthwise=d)
           for i, (f, n, p, d) in enumerate(shapes)]
    want = [ref_mp.LayerShape(f"l{i}", f, n, p, depthwise=d)
            for i, (f, n, p, d) in enumerate(shapes)]
    for rows, cols, ns in [(512, 512, 3), (128, 128, 4), (512, 512, 8)]:
        gm = [mp.map_layer(l, rows, cols, ns) for l in got]
        wm = [ref_mp.map_layer(l, rows, cols, ns) for l in want]
        assert _asdicts(gm) == _asdicts(wm)
        lat = [float(x) for x in rng.uniform(1e2, 1e5, len(gm))]
        for budget in (10, 400, 5000):
            assert _asdicts(mp.greedy_replicate(gm, lat, budget)) == \
                _asdicts(ref_mp.greedy_replicate(wm, lat, budget))
    totals = {"adc_converts": 123_456_789, "macs": 987_654_321}
    for bits in (7, 8, 24):
        assert en.pim_work_energy_pj(totals, bits) == \
            ref_en.pim_work_energy_pj(totals, bits)
    assert en.pim_work_energy_pj({}, 7) == ref_en.pim_work_energy_pj({}, 7)
    assert en.titanium_law(2.58, 0.018, 1e9, 0.7) == \
        ref_en.titanium_law(2.58, 0.018, 1e9, 0.7)


def _site_table(cfg, adaptive: bool, seed: int = 0):
    """(port, reference) site tables in a compile's order for ``cfg`` at
    full width: ``wq wk wv wo w1 w3 w2`` per layer, then the head on
    (1,)*8. Adaptive tables draw a slicing and an error per site."""
    rng = np.random.default_rng(seed)
    front = [(4, 4), (4, 2, 2), (3, 3, 2), (2, 2, 2, 2), (1,) * 8]
    d, hd = cfg.d_model, cfg.resolved_head_dim
    dims = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
            "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d),
            "w1": (d, cfg.d_ff), "w3": (d, cfg.d_ff), "w2": (cfg.d_ff, d)}
    rows = []
    for name, (d_in, d_out) in dims.items():
        g = "core" if name.startswith("w") and name[1] in "qkvo" else "ffn"
        for r in range(cfg.n_layers):
            s = front[int(rng.integers(len(front)))] if adaptive else (4, 2, 2)
            e = float(rng.uniform(0, 0.1)) if adaptive else None
            rows.append((f"blocks[0].{g}.{name}[r{r}]", d_in, d_out, s, e,
                         False))
    rows.append(("embed.head", d, cfg.vocab_size, (1,) * 8,
                 float(rng.uniform(0, 0.01)) if adaptive else None, True))
    return ([pc.SitePlan(n, i, o, s, e, 7, last) for n, i, o, s, e, last
             in rows],
            [ref_pc.SitePlan(n, i, o, s, e, 7, last) for n, i, o, s, e, last
             in rows])


@pytest.mark.parametrize("spec", [True, False])
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "chameleon-34b"])
def test_report_on_one_site_table_matches_reference(arch, adaptive, spec):
    over = dict(pim_mode="exact", pim_speculation=spec,
                pim_weight_slicing="adaptive" if adaptive else (4, 2, 2))
    cfg = dataclasses.replace(configs.get(arch), **over)
    rcfg = dataclasses.replace(ref_configs.get(arch), **over)
    sites, ref_sites = _site_table(cfg, adaptive)
    got = pc.CompiledPim(cfg=cfg, plans={}, sites=tuple(sites))
    want = ref_pc.CompiledPim(cfg=rcfg, plans={}, specs={},
                              sites=tuple(ref_sites))
    for tokens in (64, 4096):
        assert got.report(tokens=tokens) == want.report(tokens=tokens)
    rep = got.report(tokens=64)
    assert rep["n_sites"] == len(sites) == len(rep["sites"])
    assert rep["distinct_slicings"] == ["-".join(map(str, s)) for s in
                                        got.distinct_slicings()]


# ------------------------------------------- the reference's checks, on the port
def _geomean(xs):
    return float(np.exp(np.mean(np.log(xs))))


@pytest.fixture(scope="module")
def layer_sets():
    return {n: f() for n, f in wl.WORKLOADS.items()}


class TestConvertsPerMac:
    """Fig. 14 progression — exact combinatorics, no calibration."""

    def test_ideal_sequence(self):
        def ideal(a):
            return a.n_weight_slices * a.converts_per_column_pass() / a.rows
        assert ideal(en.ISAAC_8B) == pytest.approx(0.25)
        assert ideal(en.CENTER_OFFSET_ONLY) == pytest.approx(0.063, abs=0.002)
        assert ideal(en.CENTER_ADAPTIVE) == pytest.approx(0.047, abs=0.002)
        assert ideal(en.RAELLA) == pytest.approx(0.018, abs=0.002)

    def test_convert_reduction_up_to_14x(self):
        isaac = en.ISAAC_8B.n_weight_slices \
            * en.ISAAC_8B.converts_per_column_pass() / 128
        raella = en.RAELLA.n_weight_slices \
            * en.RAELLA.converts_per_column_pass() / 512
        assert 12 < isaac / raella < 15  # paper: "up to 14x fewer converts"

    def test_measured_monotone(self, layer_sets):
        seq = [en.ISAAC_8B, en.CENTER_OFFSET_ONLY, en.CENTER_ADAPTIVE,
               en.RAELLA]
        vals = [en.analyze_dnn(a, layer_sets["resnet18"]).converts_per_mac
                for a in seq]
        assert vals == sorted(vals, reverse=True)


class TestTitaniumLaw:
    def test_equation(self):
        assert en.titanium_law(2.0, 0.25, 100, 0.5) == pytest.approx(100.0)

    def test_adc_energy_scaling(self):
        assert en.adc_energy_per_convert(8) / en.adc_energy_per_convert(7) \
            == pytest.approx(2.0)


class TestFig12:
    """Efficiency/throughput vs 8b ISAAC across the seven DNNs."""

    def test_efficiency_geomean(self, layer_sets):
        ratios = [en.analyze_dnn(en.ISAAC_8B, ls).energy
                  / en.analyze_dnn(en.RAELLA, ls).energy
                  for ls in layer_sets.values()]
        g = _geomean(ratios)
        assert 3.3 <= g <= 4.5, g  # paper: 3.9x geomean
        assert min(ratios) > 2.0 and max(ratios) < 5.5  # paper: 2.9-4.9x

    def test_throughput_geomean(self, layer_sets):
        ratios = [en.analyze_dnn(en.ISAAC_8B, ls).latency_ns
                  / en.analyze_dnn(en.RAELLA, ls).latency_ns
                  for ls in layer_sets.values()]
        g = _geomean(ratios)
        assert 1.6 <= g <= 2.5, g  # paper: 2.0x geomean
        assert min(ratios) < 1.0, ratios  # compact DNNs can be slower

    def test_no_spec_tradeoff(self, layer_sets):
        eff_s, eff_n, th_s, th_n = [], [], [], []
        for ls in layer_sets.values():
            ei = en.analyze_dnn(en.ISAAC_8B, ls)
            es_ = en.analyze_dnn(en.RAELLA, ls)
            nn = en.analyze_dnn(en.RAELLA_NO_SPEC, ls)
            eff_s.append(ei.energy / es_.energy)
            eff_n.append(ei.energy / nn.energy)
            th_s.append(ei.latency_ns / es_.latency_ns)
            th_n.append(ei.latency_ns / nn.latency_ns)
        assert _geomean(eff_n) < _geomean(eff_s)   # spec buys efficiency
        assert _geomean(th_n) > _geomean(th_s)     # ...at a throughput cost
        assert 2.3 <= _geomean(th_n) <= 3.2        # paper: 2.7x

    def test_isaac_adc_dominated(self, layer_sets):
        rep = en.analyze_dnn(en.ISAAC_8B, layer_sets["resnet18"],
                             replicate=False)
        assert rep.energy_breakdown["e_adc"] / rep.energy >= 0.45  # Fig. 1

    def test_raella_adc_share_reduced(self, layer_sets):
        rep = en.analyze_dnn(en.RAELLA, layer_sets["resnet18"],
                             replicate=False)
        assert rep.energy_breakdown["e_adc"] / rep.energy < 0.25

    def test_compact_dnns_gain_least(self, layer_sets):
        gains = {n: en.analyze_dnn(en.ISAAC_8B, ls).energy
                 / en.analyze_dnn(en.RAELLA, ls).energy
                 for n, ls in layer_sets.items()}
        assert gains["mobilenet_v2"] == min(gains.values())


class TestMapping:
    def test_segmentation(self):
        m = mp.map_layer(mp.LayerShape("x", filter_len=1100, n_filters=64,
                                       n_positions=10), 512, 512, 3)
        assert m.n_segments == 3
        assert m.n_crossbars == 3 * 1  # 64 filters at 170/xbar -> 1

    def test_depthwise_poor_utilization(self):
        m = mp.map_layer(mp.LayerShape("dw", filter_len=9, n_filters=128,
                                       n_positions=100, depthwise=True),
                         512, 512, 3)
        assert m.utilization < 0.1

    def test_toeplitz_only_for_short_filters(self):
        short = mp.map_layer(mp.LayerShape("s", 100, 8, 50), 512, 512, 3)
        long_ = mp.map_layer(mp.LayerShape("l", 1000, 8, 50), 512, 512, 3)
        assert short.toeplitz_positions > 1
        assert long_.toeplitz_positions == 1

    def test_replication_respects_budget(self):
        layers = [mp.LayerShape(f"l{i}", 512, 512, 1000) for i in range(4)]
        maps = [mp.map_layer(l, 512, 512, 3) for l in layers]
        out = mp.greedy_replicate(maps, [1000.0, 2000.0, 4000.0, 8000.0],
                                  total_crossbars=64)
        assert sum(m.n_crossbars * m.replication for m in out) <= 64
        reps = [m.replication for m in out]
        assert reps == sorted(reps)  # slower layers get at least as many


@pytest.mark.parametrize("arch", ASSIGNED)
def test_macs_match_active_params(arch):
    """One forward over T tokens through the weight-static matmuls costs
    ~2 * N_active_linear * T MACs (embeddings excluded: gathers)."""
    cfg = configs.get(arch)
    T = 64
    macs = sum(l.macs for l in lm.from_arch_config(cfg, tokens=T))
    n_lin = cfg.active_param_count() - cfg.vocab_size * cfg.d_model
    assert 0.5 < macs / (n_lin * T) < 1.6, (macs / T, n_lin)


def test_moe_footprint_vs_active():
    cfg = configs.get("phi3.5-moe-42b")
    moe = [l for l in lm.from_arch_config(cfg, tokens=256) if "_e" in l.name]
    assert len(moe) == cfg.n_layers * cfg.n_experts * 3
    active_frac = cfg.experts_per_token / cfg.n_experts
    dense_w = sum(l.weights for l in moe)
    macs = sum(l.macs for l in moe)
    assert macs / (dense_w * 256) == pytest.approx(active_frac, rel=0.1)


def test_raella_beats_isaac_on_lm_zoo():
    layers = lm.from_arch_config(configs.get("yi-6b"), tokens=128)
    ri = en.analyze_dnn(en.ISAAC_8B, layers, replicate=False)
    rr = en.analyze_dnn(en.RAELLA, layers, replicate=False)
    assert 2.0 < ri.energy / rr.energy < 5.0
