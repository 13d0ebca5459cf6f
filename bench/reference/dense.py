"""Plain PyTorch reference of the dense attention models the benchmark
runs, with RAELLA's exact arithmetic in every weight-static projection.

The model: token embedding, then per layer RMSNorm, q/k/v projections
(with biases where the configuration has them), rotary positions on q and
k (the halves rotated, ``theta ** (-i / half)``), grouped-query softmax
attention (causal or not), the output projection and a residual; RMSNorm,
the gated MLP ``w2(act(w1 h) * w3 h)`` and a residual; a final RMSNorm and
the untied LM head. Everything is float32 (TF32 off) on the weights as
served (bf16 values).

Each projection is RAELLA's exact datapath at a lossless ADC, which equals
the ideal 8b-quantized product (the paper's contract; the crossbar's
Center+Offset slices, speculation and recovery change no bit of it when
no conversion saturates, and ``counters.py`` shows none can at the
configuration's ADC): weights symmetric per output column, ``scale =
max|w| / 127``, codes ``round(w / scale)``; inputs at the scale
``max|x| / 127`` of the projection's input over the calibration tokens,
codes ``round(x / scale)`` clipped to +-127; the integer product exact (in
float64), then ``(w_scale * x_scale) * acc``. The reference works the
scales and codes out again from the raw weights and the calibration
tokens, in a float forward of its own, and takes nothing the program made.

``bits`` < 8 computes the same model with ``bits``-bit codes (levels
``2 ** (bits - 1) - 1``): the control, the step below the configuration's
int8 arithmetic.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

BLOCK_ELEMENTS = 1 << 26  # weights quantized and multiplied per block


@contextlib.contextmanager
def full_float32():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    var = (x * x).mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, hd) at positions 0 .. S-1."""
    S, _, D = x.shape
    half = D // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, causal: bool) -> torch.Tensor:
    """q (S, H, D), k/v (S, K, D), H = K * G -> (S, H * D)."""
    S, H, D = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) * D ** -0.5
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, -torch.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v).reshape(S, H * D)


def act(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


class DenseReference:
    """The reference over a configuration's ``model`` sizes and weights
    ``params`` (the benchmark's tree), calibrated on ``calib`` (B, S)
    token ids."""

    def __init__(self, model: dict, params: dict, calib, bits: int = 8):
        self.model = model
        self.params = params
        self.levels = 2 ** (bits - 1) - 1
        self.x_scale: dict = {}
        dev = params["embed"]["embed"].device
        calib = torch.as_tensor(calib, device=dev)
        with torch.no_grad(), full_float32():
            every = torch.arange(calib.shape[1], device=dev)
            self._forward(list(calib), self._capture,
                          [every] * calib.shape[0])

    # -------------------------------------------------------- projections
    def _capture(self, site, x: torch.Tensor, w: torch.Tensor):
        """Float product; records the input's scale (calibration)."""
        top = x.abs().amax()
        self.x_scale[site] = (top / self.levels).clamp_min(1e-12)
        return x @ w.float()

    def _quantized(self, site, x: torch.Tensor, w: torch.Tensor):
        """The exact integer product of the codes, dequantized."""
        L = self.levels
        xs = self.x_scale[site]
        xq = torch.round(x / xs).clamp(-L, L).double()
        R, C = w.shape
        out = torch.empty((x.shape[0], C), dtype=torch.float32,
                          device=x.device)
        step = max(1, BLOCK_ELEMENTS // R)
        for c0 in range(0, C, step):
            wf = w[:, c0:c0 + step].float()
            ws = wf.abs().amax(dim=0).clamp_min(1e-12) / L
            wq = torch.round(wf / ws).clamp(-L, L).double()
            out[:, c0:c0 + step] = (ws * xs) * (xq @ wq).float()
        return out

    # -------------------------------------------------------------- model
    def _forward(self, seqs: list, proj, rows: list) -> list:
        """Sequences of token ids (each its own attention) through the
        model, all rows of a projection in one product; returns the logits
        of each sequence's ``rows``."""
        m, p = self.model, self.params
        hd, eps = m["head_dim"], m["norm_eps"]
        lens = [len(s) for s in seqs]
        x = p["embed"]["embed"][torch.cat(list(seqs))].float()
        for i, lp in enumerate(p["layers"]):
            core, ffn = lp["core"], lp["ffn"]
            h = rmsnorm(x, lp["norm1"]["scale"], eps)
            qkv = {}
            for n in "qkv":
                t = proj((i, "w" + n), h, core["w" + n])
                if m["qkv_bias"]:
                    t = t + core["b" + n].float()
                qkv[n] = t
            outs, at = [], 0
            for n_s in lens:
                q = qkv["q"][at:at + n_s].reshape(n_s, -1, hd)
                k = qkv["k"][at:at + n_s].reshape(n_s, -1, hd)
                v = qkv["v"][at:at + n_s].reshape(n_s, -1, hd)
                outs.append(attention(rope(q, m["rope_theta"]),
                                      rope(k, m["rope_theta"]), v,
                                      m["causal"]))
                at += n_s
            x = x + proj((i, "wo"), torch.cat(outs), core["wo"])
            h = rmsnorm(x, lp["norm2"]["scale"], eps)
            a = act(m["activation"])(proj((i, "w1"), h, ffn["w1"])) \
                * proj((i, "w3"), h, ffn["w3"])
            x = x + proj((i, "w2"), a, ffn["w2"])
        x = rmsnorm(x, p["final_norm"]["scale"], eps)
        starts = [0] + list(torch.tensor(lens).cumsum(0)[:-1].tolist())
        picked = torch.cat([r + s0 for r, s0 in zip(rows, starts)])
        logits = proj(("head",), x[picked], p["embed"]["head"])
        return list(logits.split([len(r) for r in rows]))

    def logits(self, seqs: list, rows: list) -> list:
        """float32 logits of ``rows`` (positions) of each sequence."""
        with torch.no_grad(), full_float32():
            return self._forward(seqs, self._quantized, rows)

