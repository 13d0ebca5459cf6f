"""The port's serving engines, import hygiene and device rule.

- Continuous batching (chunked prefill, slot reuse) gives each request
  the greedy tokens the lockstep engine gives it alone, bit for bit, in
  the float and the PIM modes (reduced yi-6b, GQA, on the CPU); a sampled
  request replays the lockstep engine's stream for its seed.
- No module of ``repro_torch`` — nor ``chip_smoke.py``'s imports — pulls
  in ``jax`` or the reference package ``repro``.
- Without CUDA the port's entry point refuses to run on its default
  device instead of carrying on on the CPU; with ``--device cpu`` it
  serves a reduced model, the paged engine included.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs, resolve_device
from repro_torch.models import pim
from repro_torch.models import transformer as T
from repro_torch.serve import ContinuousServeEngine, Request, ServeEngine

from _torch_parity import one_thread  # noqa: F401  (autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def model():
    cfg = configs.get("yi-6b").reduced(dtype="float32",
                                       kv_cache_dtype="float32")
    return cfg, T.init_params(cfg, seed=0, device="cpu")


@pytest.mark.parametrize("mode", ["off", "fast", "exact"])
def test_continuous_matches_lockstep(model, mode):
    cfg, params = model
    cfg = dataclasses.replace(cfg, pim_mode=mode)
    rng = np.random.default_rng(2)
    plans = pim.prepare_pim_params(
        params, cfg, rng.integers(0, cfg.vocab_size, (2, 8)))
    reqs = [Request(uid=u, prompt=rng.integers(0, cfg.vocab_size, n),
                    max_new_tokens=m)
            for u, (n, m) in enumerate([(5, 4), (9, 2), (3, 5), (7, 3),
                                        (4, 4)])]
    eng = ContinuousServeEngine(cfg, params, n_slots=2, max_len=16,
                                prefill_chunk=4, plans=plans)
    outs = eng.run(reqs)
    assert [o.uid for o in outs] == [r.uid for r in reqs]
    assert eng.stats.completed == len(reqs)
    lock = ServeEngine(cfg, params, max_len=16, plans=plans)
    for r, o in zip(reqs, outs):
        want = lock.generate(r.prompt[None], steps=r.max_new_tokens)
        np.testing.assert_array_equal(o.tokens, want.tokens[0])
        assert o.finish_reason == "length"


def test_sampled_stream_is_seed_reproducible(model):
    """temperature > 0: the same seed replays the stream, another seed
    gives another, and the continuous engine at B = 1 draws the lockstep
    engine's stream for the request's seed (the reference test of this
    name, on the port)."""
    cfg, params = model
    prompts = np.arange(1, 6, dtype=np.int32)[None]
    eng = ServeEngine(cfg, params, max_len=32, temperature=1.0)
    a = eng.generate(prompts, steps=12, seed=3)
    b = eng.generate(prompts, steps=12, seed=3)
    assert np.array_equal(a.tokens, b.tokens)
    c = eng.generate(prompts, steps=12, seed=4)
    assert not np.array_equal(a.tokens, c.tokens)
    ceng = ContinuousServeEngine(cfg, params, n_slots=2, max_len=32,
                                 prefill_chunk=4)
    [out] = ceng.run([Request(uid=0, prompt=prompts[0], max_new_tokens=12,
                              temperature=1.0, seed=3)])
    assert np.array_equal(out.tokens, a.tokens[0])


def test_engine_needs_plans_in_pim_modes(model):
    cfg, params = model
    with pytest.raises(ValueError):
        ContinuousServeEngine(dataclasses.replace(cfg, pim_mode="exact"),
                              params)


def test_imports_are_torch_only():
    """A fresh interpreter imports every repro_torch module (the paper
    artifacts, the training substrate and the distribution layer included)
    and chip_smoke.py; neither jax, the reference package nor the
    reference's ``benchmarks`` scripts may load, and no import opens a
    process group."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro', "
        "'benchmarks') or m.startswith(('jax.', 'jaxlib', 'repro.', "
        "'benchmarks.')))\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
        "assert 'repro_torch.serve.paged' in sys.modules\n"
        "assert 'repro_torch.paper.fig15_noise' in sys.modules\n"
        "for m in ('train.fault_tolerance', 'data.pipeline', "
        "'launch.train', 'dist', 'dist.sharding', 'dist.compat', "
        "'launch.mesh', 'train.compression'):\n"
        "    assert 'repro_torch.' + m in sys.modules, m\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized(), 'an import opened a group'\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 80  # every module was imported


def test_launcher_paged_engine_on_cpu():
    """``--engine paged`` with a pool of 2 blocks (one max-length request)
    serves the trace on the CPU and prints the pool's counters."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "yi-6b",
         "--reduced", "--device", "cpu", "--engine", "paged", "--blocks", "2",
         "--requests", "4"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert "yi-6b-smoke paged on cpu: 4 requests" in out.stdout
    assert "block pool: peak 2/2 blocks of 16" in out.stdout


def test_default_device_refuses_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen1.5-0.5b", "--pim", "exact"], capture_output=True, text=True,
        timeout=120, cwd=ROOT, env=env)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device(None)
        assert resolve_device("cpu").type == "cpu"
