"""Serve a small LM with batched requests, then run its LM head through
the RAELLA fast path (centered int8, Eq. 1) on the same model.

    python -m repro_torch.examples.serve_quantized [--device cpu]

The prompts and the head's inputs are drawn from seeded CPU
``torch.Generator``s (the reference draws them from ``jax.random``). On
the card the head runs the ``centered_int8_matmul`` CUDA kernel; with
``--device cpu``, its plain PyTorch version.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import configs, resolve_device
from repro_torch.core import pim_linear as plin
from repro_torch.examples.quickstart import rel_err, where
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine


def model_config():
    """yi-6b's family at 128 wide, 2 layers, a 512-token vocabulary."""
    return configs.get("yi-6b").reduced(d_model=128, d_ff=256, n_layers=2,
                                        vocab_size=512, n_heads=4,
                                        n_kv_heads=2, head_dim=32)


def lm_head_fast(head: torch.Tensor, x: torch.Tensor) -> tuple:
    """The head ``(d_model, vocab)`` calibrated on ``x`` (speculation off)
    and run on it through ``forward_fast``: (output, float product)."""
    plan = plin.prepare(head, x, speculation=False)
    return plin.forward_fast(x, plan), x @ head


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = model_config()
    params = T.init_params(cfg, seed=0, device=dev)
    eng = ServeEngine(cfg, params, max_len=48)
    prompts = torch.randint(0, cfg.vocab_size, (8, 8),
                            generator=torch.Generator().manual_seed(1))
    res = eng.generate(prompts.numpy(), steps=16)
    print(f"bf16 engine: {res.tokens.shape} tokens for 8 requests")

    # RAELLA fast path on the LM head (the big static matmul at decode)
    head = params["embed"]["head"].to(torch.float32)
    x = torch.randn((32, cfg.d_model),
                    generator=torch.Generator().manual_seed(2)).to(dev)
    y_fast, y_ref = lm_head_fast(head, x)
    rel = rel_err(y_fast, y_ref)
    print(f"centered-int8 LM head ({where(dev)}): rel err {rel:.4f} vs "
          f"bf16; weights stored int8 = 2x HBM traffic saved at decode")
    return dict(tokens_shape=tuple(res.tokens.shape), rel_err=rel,
                head_shape=tuple(head.shape))


if __name__ == "__main__":
    main()
