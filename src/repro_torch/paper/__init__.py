"""The paper's tables and figures through the port.

Port of the reference's paper benchmarks (``benchmarks/<name>.py``), one
module each under the same name: ``table1_slicing``, ``table2_titanium``,
``fig3_column_sums``, ``fig12_efficiency``, ``fig13_retrain``,
``fig14_ablation``, ``table4_accuracy``, ``fig15_noise``, ``lm_on_pim`` and
``compile_report``, on the shared harness ``common``. ``ENTRIES`` lists
each artifact's entry point with its headline and the reference's smoke
kwargs (``benchmarks/run.py``); every entry returns plain Python values
that ``json.dumps`` takes. The artifacts that touch tensors run on the
card unless given ``device="cpu"``; the analytic ones are pure Python.

    python -m repro_torch.paper.<module> [--device cpu]
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable


@dataclasses.dataclass(frozen=True)
class Entry:
    """One artifact: ``repro_torch.paper.<module>.<attr>``, its headline
    formatter and the kwargs that shrink it to smoke-test size.
    ``on_card``: the entry takes ``device=`` (it runs tensors)."""
    module: str
    derive: Callable[[object], str]
    smoke_kwargs: dict = dataclasses.field(default_factory=dict)
    attr: str = "run"
    on_card: bool = False

    def run(self, device=None, **kwargs):
        fn = getattr(importlib.import_module(f"repro_torch.paper."
                                             f"{self.module}"), self.attr)
        return fn(device=device, **kwargs) if self.on_card else fn(**kwargs)


ENTRIES: dict[str, Entry] = {
    "table1_slicing": Entry(
        "table1_slicing",
        lambda o: f"bits/MAC x converts/MAC tradeoff over {len(o)} slicings"),
    "table2_titanium": Entry(
        "table2_titanium",
        lambda o: "law_matches=" + str(all(v["law_matches"]
                                          for v in o.values()))),
    "fig3_column_sums": Entry(
        "fig3_column_sums",
        lambda o: "le7b: " + " -> ".join(
            f"{o[k]['le7b']:.2f}" for k in
            ["baseline_unsigned_4b", "center_offset", "adaptive_slicing",
             "recovery_cycles"]), on_card=True),
    "fig12_efficiency": Entry(
        "fig12_efficiency",
        lambda o: f"geomean eff {o['geomean']['efficiency_x']:.2f}x "
                  f"thpt {o['geomean']['throughput_x']:.2f}x "
                  f"(paper 3.9/2.0)"),
    "fig13_retrain": Entry(
        "fig13_retrain",
        lambda o: f"RAELLA {o['raella_vs_isaac']['efficiency_x']:.2f}x vs "
                  f"FORMS {o['forms8_vs_isaac']['efficiency_x']:.2f}x / "
                  f"TIMELY {o['timely_vs_isaac']['efficiency_x']:.2f}x "
                  f"(no retraining)"),
    "fig14_ablation": Entry(
        "fig14_ablation",
        lambda o: "converts/MAC " + " -> ".join(
            f"{v['ideal_converts_per_mac']:.3f}" for v in o.values())
        + " (paper 0.25->0.063->0.047->0.018)"),
    "table4_accuracy": Entry(
        "table4_accuracy",
        lambda o: f"sec4.2.1 err C+O {o['center']['sec4.2.1_error']} vs "
                  f"Z+O {o['zero']['sec4.2.1_error']}; acc drop "
                  f"{o['center']['accuracy_drop_pts']} vs "
                  f"{o['zero']['accuracy_drop_pts']} pts",
        smoke_kwargs=dict(train_steps=300, eval_n=256), on_card=True),
    "fig15_noise": Entry(
        "fig15_noise",
        lambda o: "acc@12% noise: " + " ".join(
            f"{k}={v:.2f}" for k, v in o["noise_0.12"].items()
            if isinstance(v, float)),
        smoke_kwargs=dict(noise_levels=(0.12,), eval_n=512,
                          train_steps=300), on_card=True),
    "fig15_corners": Entry(
        "fig15_noise",
        lambda o: "acc by die corner (one compiled plan): " + " ".join(
            f"{k[len('corner_'):]}={v['accuracy']:.2f}"
            for k, v in o.items() if k.startswith("corner_")),
        smoke_kwargs=dict(corners=("nominal", "3sigma"), eval_n=256,
                          train_steps=300),
        attr="run_device_corners", on_card=True),
    "table4_corners": Entry(
        "table4_accuracy",
        lambda o: f"3sigma die drop C+O "
                  f"{o['center']['3sigma']['drop_pts']} vs Z+O "
                  f"{o['zero']['3sigma']['drop_pts']} pts (no retraining)",
        smoke_kwargs=dict(corners=("nominal", "3sigma"), eval_n=256,
                          train_steps=300),
        attr="run_device_corners", on_card=True),
    "lm_on_pim": Entry(
        "lm_on_pim",
        lambda o: f"assigned-LM zoo on RAELLA silicon: "
                  f"{o['geomean_efficiency_x']}x geomean vs 8b-ISAAC",
        smoke_kwargs=dict(tokens=128)),
    "compile_report": Entry(
        "compile_report",
        lambda o: f"{o['n_sites']} sites, slices {o['slice_histogram']}, "
                  f"converts/MAC {o['converts_per_mac']}, "
                  f"adc share {o['adc_energy_share']}",
        smoke_kwargs=dict(arch="yi-6b", tokens=128, calib_len=6),
        on_card=True),
}
