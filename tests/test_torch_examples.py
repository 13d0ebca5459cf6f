"""The port's last three examples (``repro_torch.examples``) on the CPU,
against the reference's functions on the same inputs.

- ``quickstart``: the slicing Algorithm 1 chooses for the 512x64 layer,
  the integer ADC converts, speculation failures and attempts of
  ``forward_exact`` equal the reference's ``adaptive.find_best_slicing``
  and ``pim_linear.forward_exact`` (its plain path on the CPU) on the same
  numpy ``w`` and ``x``; the ResNet18 numbers equal the reference's
  ``energy.analyze_dnn`` with ``==``.
- ``serve_quantized``: the LM head through ``forward_fast`` within
  ``_torch_parity.ATOL["fast"]`` of the reference's ``forward_fast`` on
  the reference's head and ``jax.random`` inputs; the engine serves 8
  requests of 16 tokens.
- ``pim_accuracy_demo``: prints Table 4's keys, with
  ``paper.table4_accuracy.run`` held to its smoke size
  (``paper.ENTRIES``).
"""

import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as ref_configs
from repro.core import adaptive as ref_adaptive
from repro.core import energy as ref_en
from repro.core import pim_linear as ref_plin
from repro.core import workloads as ref_wl
from repro.models import transformer as RT
from repro_torch import paper
from repro_torch.examples import pim_accuracy_demo, quickstart, serve_quantized
from repro_torch.paper import table4_accuracy

from _torch_parity import ATOL, one_thread  # noqa: F401  (autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def quickstart_out() -> dict:
    return quickstart.main(["--device", "cpu"])


def test_quickstart_matches_reference():
    got = quickstart_out()
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.normal(0.01, 0.04, (512, 64)), jnp.float32)
    x = jnp.asarray(np.maximum(rng.normal(0.2, 0.4, (10, 512)), 0),
                    jnp.float32)
    choice = ref_adaptive.find_best_slicing(w, x, error_budget=0.09)
    assert got["slicing"] == tuple(choice.slicing)
    assert got["n_slices"] == choice.n_slices
    np.testing.assert_allclose(got["search_error"], float(choice.error),
                               rtol=1e-5)
    plan = ref_plin.prepare(w, x, weight_slicing=choice.slicing,
                            speculation=True)
    _, stats = ref_plin.forward_exact(x, plan, return_stats=True)
    st = stats[0]
    assert got["adc_converts"] == int(st.adc_converts)
    assert got["no_spec_converts"] == int(st.no_spec_converts)
    assert got["spec_failures"] == int(st.spec_failures)
    assert got["spec_attempts"] == int(st.spec_attempts)
    np.testing.assert_allclose(got["failure_rate"], float(st.failure_rate),
                               rtol=1e-6)
    assert 0 < got["converts_saved"] < 1
    assert got["exact_rel_err"] < 0.02 and got["fast_rel_err"] < 0.02


def test_quickstart_resnet18_equals_reference():
    got = quickstart_out()
    layers = ref_wl.resnet18()
    ri = ref_en.analyze_dnn(ref_en.ISAAC_8B, layers)
    rr = ref_en.analyze_dnn(ref_en.RAELLA, layers)
    assert got["isaac_converts_per_mac"] == ri.converts_per_mac
    assert got["raella_converts_per_mac"] == rr.converts_per_mac
    assert got["energy_x"] == ri.energy / rr.energy
    assert got["throughput_x"] == ri.latency_ns / rr.latency_ns


def test_serve_quantized_head_matches_reference():
    """The reference's head and inputs through both ``forward_fast``s."""
    cfg = serve_quantized.model_config()
    rcfg = ref_configs.get("yi-6b").reduced(
        d_model=128, d_ff=256, n_layers=2, vocab_size=512, n_heads=4,
        n_kv_heads=2, head_dim=32)
    assert (cfg.d_model, cfg.vocab_size, cfg.dtype) == (
        rcfg.d_model, rcfg.vocab_size, rcfg.dtype)
    rparams, _ = RT.init_params(rcfg, jax.random.key(0))
    head = rparams["embed"]["head"].astype(jnp.float32)
    x = jax.random.normal(jax.random.key(2), (32, rcfg.d_model))
    want = ref_plin.forward_fast(x, ref_plin.prepare(head, x,
                                                     speculation=False))
    got, y_ref = serve_quantized.lm_head_fast(
        torch.from_numpy(np.array(head)), torch.from_numpy(np.array(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL["fast"], rtol=0)
    np.testing.assert_allclose(y_ref.numpy(), np.asarray(x @ head),
                               atol=1e-5, rtol=0)


def test_serve_quantized_serves_on_the_cpu(capsys):
    out = serve_quantized.main(["--device", "cpu"])
    assert out["tokens_shape"] == (8, 16)
    assert out["head_shape"] == (128, 512)
    assert 0 < out["rel_err"] < 0.05
    text = capsys.readouterr().out
    assert "bf16 engine: (8, 16) tokens for 8 requests" in text
    assert "centered-int8 LM head (plain PyTorch version on the CPU)" in text


def test_pim_accuracy_demo_prints_table4(monkeypatch, capsys):
    smoke = paper.ENTRIES["table4_accuracy"].smoke_kwargs
    monkeypatch.setattr(table4_accuracy, "run",
                        functools.partial(table4_accuracy.run, **smoke))
    out = pim_accuracy_demo.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    keys = ["float_accuracy", "center", "zero",
            "paper_table4_drops_center_vs_zero"]
    assert list(out) == keys
    assert [line.split(" ", 1)[0] for line in lines] == keys
    assert out["center"]["sec4.2.1_error"] < 0.09


def test_quickstart_entry_point_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.quickstart", "--device",
         "cpu"], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=env)
    assert out.returncode == 0, out.stderr
    for line in ("chose (4, 2, 2) (3 slices/weight)", "23% saved",
                 "(plain PyTorch version on the CPU)", "converts/MAC"):
        assert line in out.stdout
