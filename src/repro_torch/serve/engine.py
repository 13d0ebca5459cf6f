"""Lockstep serving engine: whole-batch prefill + batched decode.

Port of ``repro.serve.engine``. With ``cfg.pim_mode != 'off'`` the engine
needs the compiled plan tree (``models.pim.prepare_pim_params``) and passes
it to every prefill/decode call. Greedy decoding is deterministic and
touches no generator.

Sampling (``temperature > 0``) draws on the host: the last position's
logits come to the CPU and ``sample`` draws from a CPU ``torch.Generator``
seeded with the call's seed, whatever the model's device. The continuous
engine samples each request's host row with the same function and a CPU
generator seeded with the request's seed, so a sampled request there
replays this engine's B = 1 stream on any device, as the reference's
contract asks. Host generators, not device ones: a CUDA generator gives
another stream than a CPU one for the same seed, and the continuous
engine already pulls every iteration's logits to the host in one copy,
so sampling there on the device would cost a sync per slot. The draws are
not the reference's ``jax.random`` stream.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray        # (B, steps) generated ids
    prompt_len: int
    steps: int


def check_plans(cfg: ArchConfig, plans: Any) -> None:
    if not cfg.causal:
        raise ValueError(f"{cfg.name} is encoder-only; no decode")
    if cfg.pim_mode != "off" and plans is None:
        raise ValueError(
            f"pim_mode={cfg.pim_mode!r} needs compiled plans — call "
            "repro_torch.models.pim.prepare_pim_params(params, cfg, "
            "calib_tokens) and pass plans=")


def sample(logits: torch.Tensor, temperature: float,
           gen: torch.Generator | None) -> torch.Tensor:
    """(B, vocab) logits -> (B,) ids on the logits' device: argmax (first
    maximum) when greedy; else one draw per row, in row order, from the
    CPU generator ``gen`` on the rows brought to the host."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.cpu().to(torch.float32) / temperature,
                          dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(logits.device)


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params: Any, *, max_len: int = 512,
                 temperature: float = 0.0, plans: Any = None):
        check_plans(cfg, plans)
        self.cfg = cfg
        self.params = params
        self.plans = plans
        self.max_len = max_len
        self.temperature = temperature

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, *, steps: int,
                 seed: int = 0) -> GenerationResult:
        """prompts: (B, prompt_len) int token ids."""
        dev = self.params["embed"]["embed"].device
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                               device=dev)
        B, plen = toks.shape
        if plen + steps > self.max_len:
            raise ValueError("prompt + steps exceeds engine max_len")
        gen = None
        if self.temperature > 0.0:
            gen = torch.Generator().manual_seed(seed)  # host: see sample
        logits, state = T.prefill(self.params, self.cfg, toks,
                                  max_len=self.max_len, plans=self.plans)
        tok = sample(logits[:, -1], self.temperature, gen)[:, None]
        out = [tok]
        for _ in range(steps - 1):
            logits, state = T.decode_step(self.params, self.cfg, state, tok,
                                          plans=self.plans)
            tok = sample(logits[:, -1], self.temperature, gen)[:, None]
            out.append(tok)
        gen_toks = torch.cat(out, dim=1).cpu().numpy()
        return GenerationResult(tokens=gen_toks, prompt_len=plen, steps=steps)
