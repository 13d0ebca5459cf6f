"""The port's training substrate against the reference's, on the CPU.

- ``train.optimizer``: ``lr_at`` in both schedules; ``global_norm``,
  ``clip_by_global_norm`` and two ``apply_updates`` steps fed the same
  numpy gradients as ``repro.train.optimizer``, new params and moments to
  float32 rounding (``rtol=1e-6``); bf16 moments stay bf16.
- ``data.pipeline.SyntheticLM``: batches and ``entropy_floor`` ``==`` the
  reference's.
- ``train.train_loop``: one step of reduced qwen1.5-0.5b (float32, vocab
  64, 8 x 32 tokens, the sizes of ``tests/test_train_system.py``) from the
  reference's weights, with 1 and 4 micro-batches, against the
  reference's jitted step: the loss within 1e-5 relative, the params by
  relative global norm (< 1e-3; at step 1 AdamW moves each weight by about
  ``lr * sign(g)``, so a gradient within rounding of 0 may move one weight
  by 2 lr); 4 micro-batches against 1; the loss falls by 0.3 in 30 steps.
- ``train.checkpoint`` and ``train.fault_tolerance``: the reference's own
  checks (round trip with a bf16 leaf, a stale .tmp ignored, three kept,
  the async save, restart after an injected failure reaching step 20), a
  structure mismatch raising, the async snapshot taken before the next
  in-place step.
- ``launch.train`` and ``examples``: on the CPU, and refusing without a
  card when no device is named.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data.pipeline import SyntheticLM as RefLM
from repro.models import transformer as RT
from repro.train import optimizer as ropt
from repro.train import train_loop as rtl
from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLM, TeacherDataset
from repro_torch.examples import elastic_restart_demo, train_e2e
from repro_torch.launch import train as launch_train
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.train import _tree
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import fault_tolerance as ft
from repro_torch.train import optimizer as opt
from repro_torch.train import train_loop as tl

from _torch_parity import one_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen1.5-0.5b"
CFG = configs.get(ARCH).reduced(vocab_size=64)       # bf16, as the reference's
F32 = dict(vocab_size=64, dtype="float32")
OPT_KW = dict(lr=3e-3, warmup_steps=5, total_steps=200, weight_decay=0.01)
OPT, ROPT = opt.AdamWConfig(**OPT_KW), ropt.AdamWConfig(**OPT_KW)
RTOL = 1e-6


def _data(start=0):
    return SyntheticLM(vocab_size=64, seq_len=32, batch_size=8,
                       seed=7).iterator(start)


def _f32_setup():
    """Reduced float32 qwen in both packages from the reference's weights,
    and the reference's numpy params."""
    rcfg = ref_configs.get(ARCH).reduced(**F32)
    cfg = configs.get(ARCH).reduced(**F32)
    rparams, _ = RT.init_params(rcfg, jax.random.key(0))
    np_params = jax.tree.map(np.array, rparams)  # a copy: updated in place
    return rcfg, cfg, rparams, np_params, convert.params_from_reference(
        np_params, cfg, "cpu")


def _port_tree(np_tree, cfg) -> dict:
    return convert.params_from_reference(np_tree, cfg, "cpu")


def _close(got, want, rtol=RTOL):
    """Leaf by leaf, to ``rtol`` and an absolute floor of ``rtol`` times
    the leaf's largest magnitude."""
    for g, w in zip(_tree.leaves(got), _tree.leaves(want), strict=True):
        w = w.to(torch.float32).numpy()
        np.testing.assert_allclose(g.to(torch.float32).numpy(), w, rtol=rtol,
                                   atol=rtol * float(np.abs(w).max()))


def _rel_norm(a, b) -> float:
    d = opt.global_norm(_tree.tree_map(lambda x, y: x.float() - y.float(),
                                       a, b))
    return float(d) / float(opt.global_norm(b))


# ---------------------------------------------------------------- optimizer
@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_lr_at_matches_reference(schedule):
    cfg = dataclasses.replace(OPT, schedule=schedule)
    rcfg = dataclasses.replace(ROPT, schedule=schedule)
    for step in (0, 5, 100, 200):
        got = opt.lr_at(cfg, torch.tensor(step, dtype=torch.int32))
        want = float(ropt.lr_at(rcfg, jnp.asarray(step, jnp.int32)))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=RTOL, abs=1e-12)
    assert float(opt.lr_at(OPT, 0)) == 0.0
    assert float(opt.lr_at(OPT, 5)) == pytest.approx(OPT.lr)


def _grads(np_params, seed: int, scale: float):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale
                                   ).astype(np.float32), np_params)


def test_clip_and_global_norm_match_reference():
    _, cfg, _, np_params, _ = _f32_setup()
    np_g = _grads(np_params, 0, 0.05)
    g = _port_tree(np_g, cfg)
    rg = jax.tree.map(jnp.asarray, np_g)
    assert float(opt.global_norm(g)) == pytest.approx(
        float(ropt.global_norm(rg)), rel=RTOL)
    clipped, gn = opt.clip_by_global_norm(g, 1.0)
    rclipped, rgn = ropt.clip_by_global_norm(rg, 1.0)
    assert float(gn) > 1.0
    assert float(gn) == pytest.approx(float(rgn), rel=RTOL)
    _close(clipped, _port_tree(jax.tree.map(np.array, rclipped), cfg))
    assert float(opt.global_norm(clipped)) == pytest.approx(1.0, rel=1e-3)
    small, _ = opt.clip_by_global_norm({"a": torch.full((10,), 0.01)}, 1.0)
    assert torch.equal(small["a"], torch.full((10,), 0.01))
    bf, _ = opt.clip_by_global_norm(
        {"a": torch.full((10,), 100.0, dtype=torch.bfloat16)}, 1.0)
    assert bf["a"].dtype == torch.bfloat16


def test_apply_updates_matches_reference():
    """Two AdamW steps in place on the reference's weights and gradients
    (the second with nonzero moments, the first under clipping)."""
    _, cfg, rparams, np_params, params = _f32_setup()
    state, rstate = opt.init_state(OPT, params), ropt.init_state(ROPT,
                                                                 rparams)
    for i, scale in enumerate((0.05, 1e-3)):
        np_g = _grads(np_params, i, scale)
        before = [p.clone() for p in _tree.leaves(params)]
        params2, state2, m = opt.apply_updates(OPT, params, _port_tree(
            np_g, cfg), state)
        assert params2 is params and state2 is state   # in place
        assert any(not torch.equal(a, b) for a, b in
                   zip(before, _tree.leaves(params)))
        rparams, rstate, rm = ropt.apply_updates(
            ROPT, rparams, jax.tree.map(jnp.asarray, np_g), rstate)
        assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=RTOL)
        assert float(m["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=RTOL)
        for got, want in ((params, rparams), (state["m"], rstate["m"]),
                          (state["v"], rstate["v"])):
            _close(got, _port_tree(jax.tree.map(np.array, want), cfg))
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 2


def test_bf16_state_dtype():
    """bf16 moments stay bf16 through a step, beside float32 params, and
    equal the reference's to a bf16 rounding."""
    ocfg = dataclasses.replace(OPT, state_dtype="bfloat16")
    rocfg = dataclasses.replace(ROPT, state_dtype="bfloat16")
    _, cfg, rparams, np_params, params = _f32_setup()
    state = opt.init_state(ocfg, params)
    assert all(t.dtype == torch.bfloat16
               for t in _tree.leaves((state["m"], state["v"])))
    np_g = _grads(np_params, 0, 1e-3)
    opt.apply_updates(ocfg, params, _port_tree(np_g, cfg), state)
    _, rstate, _ = ropt.apply_updates(rocfg, rparams, jax.tree.map(
        jnp.asarray, np_g), ropt.init_state(rocfg, rparams))
    assert all(t.dtype == torch.bfloat16
               for t in _tree.leaves((state["m"], state["v"])))
    assert all(t.dtype == torch.float32 for t in _tree.leaves(params))
    for name in ("m", "v"):
        _close(state[name], _port_tree(jax.tree.map(
            lambda a: np.asarray(a, np.float32), rstate[name]), cfg),
            rtol=2 ** -8)


# ---------------------------------------------------------------- data
@pytest.mark.parametrize("kw", [dict(vocab_size=64, seq_len=32, batch_size=8,
                                     seed=7),
                                dict(vocab_size=256, seq_len=128,
                                     batch_size=4, seed=0,
                                     concentration=0.1)])
def test_synthetic_lm_equals_reference(kw):
    mine, ref = SyntheticLM(**kw), RefLM(**kw)
    assert mine.entropy_floor() == ref.entropy_floor()
    for step in (0, 3, 1000):
        got, want = mine.batch(step), ref.batch(step)
        for k in ("inputs", "labels"):
            assert got[k].dtype == torch.int32
            assert got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
    it, rit = mine.iterator(5, host=1, num_hosts=2), ref.iterator(
        5, host=1, num_hosts=2)
    for _ in range(2):
        np.testing.assert_array_equal(next(it)["inputs"].numpy(),
                                      np.asarray(next(rit)["inputs"]))


def test_teacher_dataset():
    """Deterministic per (seed, step), labels the argmax of the teacher."""
    ds = TeacherDataset(d_in=16, n_classes=5, seed=2, device="cpu")
    x, y = ds.batch(3, 64)
    assert x.shape == (64, 16) and y.shape == (64,)
    x2, y2 = TeacherDataset(d_in=16, n_classes=5, seed=2,
                            device="cpu").batch(3, 64)
    assert torch.equal(x, x2) and torch.equal(y, y2)
    assert not torch.equal(ds.batch(4, 64)[0], x)
    assert torch.equal(y, torch.argmax(torch.relu(x @ ds.w1) @ ds.w2, -1))
    assert 1 < len(torch.unique(y)) <= 5


# ---------------------------------------------------------------- train step
@pytest.mark.parametrize("micro", [1, 4])
def test_one_step_matches_reference(micro):
    rcfg, cfg, rparams, _, params = _f32_setup()
    rcfg = dataclasses.replace(rcfg, micro_batches=micro)
    cfg = dataclasses.replace(cfg, micro_batches=micro)
    batch = SyntheticLM(64, 32, 8, seed=3).batch(0)
    rbatch = RefLM(64, 32, 8, seed=3).batch(0)
    rp, _, rm = jax.jit(rtl.make_train_step(rcfg, ROPT))(
        rparams, ropt.init_state(ROPT, rparams), rbatch)
    p, state, m = tl.make_train_step(cfg, OPT)(
        params, opt.init_state(OPT, params), batch)
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                  rel=1e-4)
    assert _rel_norm(p, _port_tree(jax.tree.map(np.array, rp), cfg)) < 1e-3
    assert int(state["step"]) == 1
    assert not any(t.requires_grad for t in _tree.leaves(p))


def test_microbatched_step_matches_full():
    """Gradient accumulation over 4 micro-batches against one batch, as
    ``TestTrainLoop.test_microbatched_step_matches_full``; accumulated
    gradients are in ``opt_state_dtype``, single-batch ones in the
    parameters' dtype (bf16 here)."""
    cfg4 = dataclasses.replace(CFG, micro_batches=4)
    batch = SyntheticLM(64, 32, 8, seed=3).batch(0)
    p0 = T.init_params(CFG, seed=0, device="cpu")
    l1, g1 = tl.make_grad_fn(CFG)(p0, batch)
    l4, g4 = tl.make_grad_fn(cfg4)(p0, batch)
    assert {t.dtype for t in _tree.leaves(g1)} == {torch.bfloat16}
    assert {t.dtype for t in _tree.leaves(g4)} == {torch.float32}
    outs = []
    for cfg in (CFG, cfg4):
        params = _tree.tree_map(torch.clone, p0)
        outs.append(tl.make_train_step(cfg, OPT)(
            params, opt.init_state(OPT, params), batch))
    (p1, _, m1), (p4, _, m4) = outs
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-2)
    assert float(l1) == float(m1["loss"]) and float(l4) == float(m4["loss"])
    assert _rel_norm(p4, p1) < 1e-2


def test_loss_decreases():
    """30 steps on the port's own weights bring the held-out loss 0.3
    below an untrained model's, as ``TestTrainLoop.test_loss_decreases``."""
    data = SyntheticLM(vocab_size=64, seq_len=32, batch_size=8, seed=7)
    state = tl.train(CFG, OPT, data.iterator(0), num_steps=30, log_every=0,
                     device="cpu")
    with torch.no_grad():
        trained = T.lm_loss(state.params, CFG, data.batch(1000))
        untrained = T.lm_loss(T.init_params(CFG, seed=1, device="cpu"), CFG,
                              data.batch(1000))
    assert float(trained) < float(untrained) - 0.3
    assert state.step == 30 and int(state.opt_state["step"]) == 30


# ---------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(10.0), "b": [torch.ones((3, 4),
                                                       dtype=torch.bfloat16)],
            "s": torch.tensor(7, dtype=torch.int32)}
    tree["b"][0][1, 2] = 1.0078125  # a bf16 value float16 cannot hold
    ckpt.save(str(tmp_path), 7, tree, extra={"note": "x"})
    like = _tree.tree_map(torch.zeros_like, tree)
    got, step, extra = ckpt.restore(str(tmp_path), like)
    assert step == 7 and extra == {"note": "x"}
    for g, w in zip(_tree.leaves(got), _tree.leaves(tree)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    meta = (tmp_path / "step_000000007" / "manifest.json").read_text()
    assert '"bfloat16"' in meta and '"b/0"' in meta
    assert np.load(tmp_path / "step_000000007" / "arr_000001.npy").dtype \
        == np.uint16
    # restore converts to the like-tree's dtype
    got32, _, _ = ckpt.restore(str(tmp_path), _tree.tree_map(
        lambda t: t.float(), tree))
    assert got32["b"][0].dtype == torch.float32
    assert torch.equal(got32["b"][0], tree["b"][0].float())


def test_train_state_roundtrip(tmp_path):
    """(params, opt_state) of a bf16 model round-trips bit for bit."""
    params = T.init_params(CFG, seed=0, device="cpu")
    state = opt.init_state(OPT, params)
    tl.make_train_step(CFG, OPT)(params, state, _data().__next__())
    ckpt.save(str(tmp_path), 1, (params, state))
    fresh = T.init_params(CFG, seed=5, device="cpu")
    (p, s), step, _ = ckpt.restore(str(tmp_path),
                                   (fresh, opt.init_state(OPT, fresh)))
    assert step == 1
    for g, w in zip(_tree.leaves((p, s)), _tree.leaves((params, state))):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_atomic_no_partial(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(4)})
    os.makedirs(tmp_path / "step_000000009.tmp")  # a stale .tmp is ignored
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert ckpt.latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "missing"), {"a": torch.zeros(4)})


def test_gc_keeps_three(tmp_path):
    for s in range(6):
        ckpt.save(str(tmp_path), s, {"a": torch.zeros(2)})
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == [f"step_{s:09d}" for s in (3, 4, 5)]


def test_async_checkpointer(tmp_path):
    """The save holds the values of the call, not of later in-place
    updates."""
    tree = {"a": torch.arange(5.0)}
    ac = ckpt.AsyncCheckpointer(str(tmp_path))
    ac.save(3, tree)
    tree["a"].add_(100.0)
    ac.wait()
    assert ckpt.latest_step(str(tmp_path)) == 3
    got, _, _ = ckpt.restore(str(tmp_path), tree)
    assert torch.equal(got["a"], torch.arange(5.0))


@pytest.mark.parametrize("like", [
    {"a": torch.zeros(4), "b": torch.zeros(2)},   # leaf count
    {"c": torch.zeros(4)},                          # key path
    {"a": torch.zeros(5)},                          # shape
])
def test_mismatched_structure_raises(tmp_path, like):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(4)})
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), like)


# ---------------------------------------------------------------- faults
def test_straggler_monitor():
    mon = ft.StragglerMonitor(threshold=2.0, min_samples=3)
    for i in range(5):
        assert not mon.observe(i, 0.1)
    assert mon.observe(5, 0.5)
    assert len(mon.events) == 1


def test_elastic_axis():
    assert ft.elastic_data_axis(512, 16) == 32
    assert ft.elastic_data_axis(480, 16) == 30  # lost a host
    with pytest.raises(ValueError):
        ft.elastic_data_axis(8, 16)


def test_restart_from_failure(tmp_path, capsys):
    """A crash injected at step 12 resumes from step 10's checkpoint and
    reaches step 20."""
    crashed = {"done": False}

    def injector(step):
        if step == 12 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("injected node failure")

    state = ft.resilient_train(
        CFG, OPT, _data, num_steps=20, ckpt_dir=str(tmp_path),
        ckpt_every=5, fail_injector=injector, device="cpu")
    assert state.step == 20 and crashed["done"]
    assert ckpt.latest_step(str(tmp_path)) == 20
    assert int(state.opt_state["step"]) == 20
    assert "[restart] resumed from step 10" in capsys.readouterr().out


def test_restart_gives_up_after_max_restarts(tmp_path):
    def always(step):
        raise OSError("disk gone")

    with pytest.raises(OSError):
        ft.resilient_train(CFG, OPT, _data, num_steps=3,
                           ckpt_dir=str(tmp_path), max_restarts=1,
                           fail_injector=always, device="cpu")


# ---------------------------------------------------------------- launcher
def test_launcher_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--reduced", "--steps", "3", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert "training qwen1.5-0.5b-smoke:" in out.stdout
    assert "done at step 3" in out.stdout


def test_launcher_resilient_in_process(tmp_path, capsys):
    d = str(tmp_path / "ck")
    launch_train.main(["--arch", ARCH, "--reduced", "--steps", "6",
                       "--ckpt-dir", d, "--ckpt-every", "5", "--resilient",
                       "--device", "cpu"])
    assert "done at step 6" in capsys.readouterr().out
    assert ckpt.latest_step(d) == 6
    launch_train.main(["--arch", ARCH, "--reduced", "--steps", "5",
                       "--ckpt-dir", str(tmp_path / "plain"),
                       "--ckpt-every", "5", "--device", "cpu"])
    assert ckpt.latest_step(str(tmp_path / "plain")) == 5
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", ARCH, "--reduced", "--resilient",
                           "--device", "cpu"])


def test_default_device_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (launch_train.main, train_e2e.main,
                 elastic_restart_demo.main):
        args = ["--arch", ARCH, "--reduced"] if main is launch_train.main \
            else []
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(args)


def test_examples_on_cpu(capsys):
    train_e2e.main(["--steps", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "final eval loss" in out and "stragglers flagged" in out
    elastic_restart_demo.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "[restart] resumed from step 20" in out
    assert "finished at step 50" in out
