"""Gradients of the port's ``lm_loss`` against the reference's, on the CPU.

The reference's weights are carried across (``convert.params_from_
reference``); the port's ``torch.autograd.grad`` (through
``train_loop.make_grad_fn``) is held to ``jax.grad`` of
``repro.models.transformer.lm_loss`` on one batch of 2 x 16 tokens, with
``LOSS_CHUNK`` set to 8 in both packages so that two checkpointed logits
chunks run. Every float32 ``reduced(vocab_size=64)`` config below: the
loss to 1e-5 relative and each gradient leaf to ``rtol=1e-4`` with an
absolute floor of 1e-4 times the reference leaf's largest magnitude (the
worst seen is ~3e-5 relative, rwkv6's). qwen and jamba also run with
``remat=True`` (each layer under ``torch.utils.checkpoint``), which must
give the same loss and gradients bit for bit. One bf16 case (qwen) is held
on the loss (1e-2 relative) and the global gradient norm (2e-2).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.train import _tree
from repro_torch.train import optimizer as opt
from repro_torch.train import train_loop as tl

from _torch_parity import one_thread  # noqa: F401  (autouse fixture)

ARCHS = ("qwen1.5-0.5b", "phi3.5-moe-42b", "jamba-1.5-large-398b",
         "rwkv6-3b", "raella-bert-large")
REMAT = ("qwen1.5-0.5b", "jamba-1.5-large-398b")
B, S, CHUNK = 2, 16, 8
RTOL = 1e-4


@pytest.fixture
def chunked(monkeypatch):
    monkeypatch.setattr(T, "LOSS_CHUNK", CHUNK)
    monkeypatch.setattr(RT, "LOSS_CHUNK", CHUNK)


@functools.lru_cache(maxsize=None)
def _case(arch: str, dtype: str):
    """Both configs, the reference's numpy weights, the batch, and the
    reference's loss and numpy gradients (with ``LOSS_CHUNK`` = 8: every
    caller runs under ``chunked``); shared by the remat on/off cases."""
    rcfg = ref_configs.get(arch).reduced(vocab_size=64, dtype=dtype)
    cfg = configs.get(arch).reduced(vocab_size=64, dtype=dtype)
    rparams, _ = RT.init_params(rcfg, jax.random.key(0))
    np_params = jax.tree.map(lambda a: np.array(a, np.float32), rparams)
    rng = np.random.default_rng(11)
    batch = {"inputs": rng.integers(0, 64, (B, S)).astype(np.int32),
             "labels": rng.integers(0, 64, (B, S)).astype(np.int32)}
    loss, g = jax.jit(jax.value_and_grad(
        lambda p, b: RT.lm_loss(p, rcfg, b)))(
            rparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return (cfg, np_params, batch, float(loss),
            jax.tree.map(lambda a: np.array(a, np.float32), g))


def _port(cfg, params, batch):
    return tl.make_grad_fn(cfg)(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("arch,remat",
                         [(a, False) for a in ARCHS]
                         + [(a, True) for a in REMAT])
def test_grads_match_reference(arch, remat, chunked):
    cfg, np_params, batch, want_loss, np_grads = _case(arch, "float32")
    params = convert.params_from_reference(np_params, cfg, "cpu")
    loss, grads = _port(dataclasses.replace(cfg, remat=remat), params, batch)
    assert float(loss) == pytest.approx(want_loss, rel=1e-5)
    want = convert.params_from_reference(np_grads, cfg, "cpu")
    paths, got = _tree.flatten(grads)
    assert paths == _tree.flatten(want)[0]
    for path, g, w in zip(paths, got, _tree.leaves(want)):
        assert g.dtype == w.dtype, path
        w = w.numpy()
        np.testing.assert_allclose(
            g.numpy(), w, rtol=RTOL, atol=RTOL * float(np.abs(w).max()),
            err_msg=path)
    assert float(opt.global_norm(grads)) > 0
    if remat:  # remat recomputes the same values
        loss0, grads0 = _port(cfg, params, batch)
        assert float(loss0) == float(loss)
        for g, g0 in zip(_tree.leaves(grads), _tree.leaves(grads0)):
            assert torch.equal(g, g0)


def test_remat_wraps_only_while_recording(monkeypatch):
    """``forward_hidden`` checkpoints its layers only while autograd
    records: never under ``no_grad`` (the serving paths), nor when no
    parameter requires grad."""
    calls = []
    real = T.checkpoint
    monkeypatch.setattr(T, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = dataclasses.replace(configs.get("qwen1.5-0.5b").reduced(
        vocab_size=64, dtype="float32"), remat=True)
    params = T.init_params(cfg, seed=0, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    with torch.no_grad():
        T.forward_hidden(params, cfg, tokens)
    T.forward_hidden(params, cfg, tokens)
    assert calls == []
    params["layers"][0]["ffn"]["w1"].requires_grad_(True)
    T.forward_hidden(params, cfg, tokens)
    assert len(calls) == cfg.n_layers


def test_bf16_loss_and_grad_norm(chunked):
    cfg, np_params, batch, want_loss, np_grads = _case("qwen1.5-0.5b",
                                                       "bfloat16")
    params = convert.params_from_reference(np_params, cfg, "cpu")
    loss, grads = _port(cfg, params, batch)
    assert {g.dtype for g in _tree.leaves(grads)} == {torch.bfloat16}
    assert float(loss) == pytest.approx(want_loss, rel=1e-2)
    want_norm = float(np.sqrt(sum(float(np.sum(np.square(g)))
                                  for g in jax.tree.leaves(np_grads))))
    assert float(opt.global_norm(grads)) == pytest.approx(want_norm,
                                                          rel=2e-2)
