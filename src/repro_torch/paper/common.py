"""Shared harness of the paper artifacts: realistic synthetic layers and a
small trained classifier for the end-to-end accuracy experiments.

Port of the reference's ``benchmarks/common.py``. Every random number
comes from ``KEY(seed)`` (``core.rng.Key``), derived in the reference's
order: ``KEY(seed).split(2)`` for the teacher's weights, ``KEY(seed +
42).fold_in(step)`` for a batch, ``KEY(seed + 10).split(2)`` for the
student's initial weights and ``KEY(seed).fold_in(idx)`` for a layer's
noise. ``KEY`` is read at each call, so a caller may stand in another key
type (the parity tests pass the reference's ``jax.random`` draws). Tensors
live on an explicit device; the entry points default to the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import adc as adc_lib
from repro_torch.core import backends as bk
from repro_torch.core import center_offset as co
from repro_torch.core import pim_linear as plin
from repro_torch.core import rng

KEY = rng.Key  # the key type of every random draw below


def realistic_layer(gen: np.random.Generator, rows: int = 512,
                    cols: int = 64, w_scale: float = 12.0,
                    in_mean: float = 12.0, in_sparsity: float = 0.4,
                    skew: float = 0.0, device="cpu"):
    """DNN-like integer layer: peaked (Laplacian) weights, sparse
    right-skewed unsigned inputs (paper Fig. 8 distributions), drawn from
    numpy's ``gen``. Returns (w_u (rows, cols), x (16, rows)) int64 on
    ``device``."""
    w_signed = np.clip(gen.laplace(skew, w_scale, size=(rows, cols)),
                       -127, 127)
    w_u = (np.round(w_signed) + 128).astype(np.int64)
    x_raw = gen.exponential(in_mean, size=(16, rows))
    x_raw = x_raw * (gen.random((16, rows)) > in_sparsity)
    x = np.clip(x_raw, 0, 255).astype(np.int64)
    return torch.from_numpy(w_u).to(device), torch.from_numpy(x).to(device)


@contextlib.contextmanager
def float32_matmuls():
    """Full float32 products on the card: TF32 would round the classifier's
    matmuls to 10 mantissa bits."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


# ------------------------------------------------------------- tiny MLP
@dataclasses.dataclass
class PosTeacher:
    """Teacher task on *positive* inputs (post-ReLU-like activations).

    The bias-free student must encode input means inside its weights, which
    produces the per-channel skewed weight columns of real pretrained nets
    (paper Fig. 5) — the regime where differential (Zero+Offset) encoding
    saturates and Center+Offset does not.
    """
    d_in: int = 128
    n_classes: int = 8
    seed: int = 0
    device: torch.device | str = "cpu"

    def __post_init__(self):
        k1, k2 = KEY(self.seed).split(2)
        self.tw1 = k1.normal((self.d_in, 64), self.device) * self.d_in ** -0.5
        self.tw2 = k2.normal((64, self.n_classes), self.device) * 64 ** -0.5

    def batch(self, step: int, n: int):
        """(x (n, d_in) float32 >= 0, labels (n,) int64) of batch ``step``;
        the labels centre x on its one scalar mean, as the reference."""
        x = KEY(self.seed + 42).fold_in(step).normal((n, self.d_in),
                                                     self.device).abs()
        with float32_matmuls():
            y = torch.argmax(torch.relu((x - x.mean()) @ self.tw1)
                             @ self.tw2, -1)
        return x, y


@dataclasses.dataclass
class MLP:
    """Bias-free 2-layer ReLU MLP (weights carry the offsets)."""
    w1: torch.Tensor
    w2: torch.Tensor

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x @ self.w1) @ self.w2


def mlp_from_reference(w1: np.ndarray, w2: np.ndarray, device="cpu") -> MLP:
    """The reference's MLP weights (numpy float32) as the port's ``MLP``."""
    return MLP(torch.from_numpy(np.array(w1, np.float32)).to(device),
               torch.from_numpy(np.array(w2, np.float32)).to(device))


def trained_mlp(d_in: int = 128, hidden: int = 256, n_classes: int = 8,
                steps: int = 1500, seed: int = 0, device="cpu"):
    """Train the bias-free classifier on ``device``; returns (mlp,
    dataset). One training per (sizes, steps, seed, device)."""
    return _trained(d_in, hidden, n_classes, steps, seed,
                    str(torch.device(device)))


@functools.lru_cache(maxsize=4)
def _trained(d_in, hidden, n_classes, steps, seed, device):
    """Plain SGD at 0.3 * 0.999**i on the mean log-softmax loss of 256-row
    batches, float32 throughout: a float model trained outside any
    crossbar, so ``torch.matmul`` and autograd are the tools."""
    ds = PosTeacher(d_in=d_in, n_classes=n_classes, seed=seed, device=device)
    k1, k2 = KEY(seed + 10).split(2)
    w1 = k1.normal((d_in, hidden), device) * d_in ** -0.5
    w2 = k2.normal((hidden, n_classes), device) * hidden ** -0.5
    with float32_matmuls():
        for i in range(steps):
            x, y = ds.batch(i, 256)
            w1.requires_grad_(True)
            w2.requires_grad_(True)
            lg = MLP(w1, w2).logits(x)
            loss = -torch.log_softmax(lg, -1).gather(1, y[:, None]).mean()
            g1, g2 = torch.autograd.grad(loss, (w1, w2))
            lr = 0.3 * (0.999 ** i)
            w1, w2 = (w1 - lr * g1).detach(), (w2 - lr * g2).detach()
    return MLP(w1, w2), ds


def mlp_accuracy(mlp: MLP, ds: PosTeacher, n: int = 2048,
                 layer_fn=None) -> float:
    """Accuracy on batch 99991; ``layer_fn(x, w, idx)`` optionally
    replaces both matmuls (the PIM path)."""
    x, y = ds.batch(99991, n)
    with torch.no_grad(), float32_matmuls():
        if layer_fn is None:
            pred = torch.argmax(mlp.logits(x), -1)
        else:
            h = torch.relu(layer_fn(x, mlp.w1, 0))
            pred = torch.argmax(layer_fn(h, mlp.w2, 1), -1)
    return float((pred == y).to(torch.float32).mean())


def calibration(mlp: MLP, ds: PosTeacher):
    """The ten calibration inputs (the paper's) of each layer: (x_cal,
    h_cal)."""
    x_cal, _ = ds.batch(77, 10)
    with torch.no_grad(), float32_matmuls():
        return x_cal, torch.relu(x_cal @ mlp.w1)


def build_pim_plans(mlp: MLP, ds: PosTeacher, *, encode_mode="center",
                    weight_slicing=(4, 2, 2), adc=adc_lib.RAELLA_ADC,
                    speculation=True, rows_per_xbar=512, cal=None) -> dict:
    """Compile both MLP matmuls into PimPlans — the write-once step.

    The plans are die-agnostic: ``plans_layer_fn`` reads them through any
    number of analog array models without re-encoding (ReRAM's
    write-once/read-many). ``rows_per_xbar`` re-encodes the quantized
    weights on shorter crossbars (ISAAC's 128 rows). ``cal`` (x_cal,
    h_cal) overrides ``calibration(mlp, ds)``."""
    x_cal, h_cal = calibration(mlp, ds) if cal is None else cal

    def build(w, x):
        plan = plin.prepare(w, x, weight_slicing=weight_slicing, adc=adc,
                            speculation=speculation, encode_mode=encode_mode)
        if rows_per_xbar != co.ROWS_PER_CROSSBAR:
            enc = co.encode(plan.w_q.to(torch.int64) + 128, weight_slicing,
                            mode=encode_mode, rows_per_xbar=rows_per_xbar)
            plan = dataclasses.replace(plan, enc=enc)
        return plan

    with torch.no_grad():
        return {0: build(mlp.w1, x_cal), 1: build(mlp.w2, h_cal)}


def die(corner: str, seed: int = 0) -> bk.NonidealSim:
    """A ReRAM die at a named corner (``core.backends.CORNERS``), its fault
    maps and write errors drawn from ``KEY(seed)``."""
    return bk.NonidealSim(corner=bk.corner(corner), key=KEY(seed))


def plans_layer_fn(plans: dict, *, noise_level: float = 0.0, seed: int = 0,
                   die: bk.CrossbarBackend | None = None):
    """Layer function reading through already-compiled plans; layer
    ``idx`` draws its ADC noise from ``KEY(seed).fold_in(idx)``.

    ``die`` swaps the analog array model — e.g. a ``NonidealSim`` corner —
    without touching the compiled encode, so a corner sweep answers "does
    this exact programmed image survive a 3-sigma die?"."""
    if die is not None:
        plans = {i: dataclasses.replace(p, device=die)
                 for i, p in plans.items()}
    key = KEY(seed)

    def layer(x, w, idx):
        return plin.forward_exact(x, plans[idx], noise_level=noise_level,
                                  key=key.fold_in(idx))
    return layer


def pim_layer_fn(mlp: MLP, ds: PosTeacher, *, encode_mode="center",
                 weight_slicing=(4, 2, 2), adc=adc_lib.RAELLA_ADC,
                 speculation=True, noise_level=0.0, seed=0,
                 rows_per_xbar=512, die=None):
    """A layer function running both MLP matmuls through the exact
    accelerator simulation (plans prepared once, reused per call)."""
    plans = build_pim_plans(mlp, ds, encode_mode=encode_mode,
                            weight_slicing=weight_slicing, adc=adc,
                            speculation=speculation,
                            rows_per_xbar=rows_per_xbar)
    return plans_layer_fn(plans, noise_level=noise_level, seed=seed, die=die)
