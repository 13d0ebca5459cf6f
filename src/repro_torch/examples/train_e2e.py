"""End-to-end training example: train a qwen1.5-0.5b-family model on the
synthetic Markov LM for a few hundred steps with straggler monitoring.

  python -m repro_torch.examples.train_e2e [--steps 300] [--full-100m]

The default model is small (4 layers, d_model 128, vocab 256); with
--full-100m it builds the ~100M-parameter variant (12 layers, d_model
768, vocab 8192). Runs on the CUDA card unless ``--device cpu`` is given.
"""

import argparse
import dataclasses
import math

import torch

from repro_torch import configs, resolve_device
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import transformer as T
from repro_torch.train import fault_tolerance as ft
from repro_torch.train import optimizer as opt
from repro_torch.train import train_loop as tl


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    base = configs.get("qwen1.5-0.5b")
    if args.full_100m:
        cfg = dataclasses.replace(
            base, name="qwen-100m", n_layers=12, d_model=768, n_heads=12,
            n_kv_heads=12, d_ff=2048, vocab_size=8192, head_dim=64,
            remat=False)
    else:
        cfg = base.reduced(n_layers=4, d_model=128, d_ff=256, vocab_size=256,
                           n_heads=4, n_kv_heads=4, head_dim=32)
    print(f"model: {cfg.param_count()/1e6:.1f}M params")
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=128, batch_size=16,
                       seed=0, concentration=0.1)
    print(f"synthetic LM entropy floor: {data.entropy_floor():.3f} nats")
    opt_cfg = opt.AdamWConfig(lr=2e-2, warmup_steps=20,
                              total_steps=args.steps)
    mon = ft.StragglerMonitor()
    state = tl.train(cfg, opt_cfg, data.iterator(0), num_steps=args.steps,
                     hooks=[mon.hook()], log_every=25, device=dev)
    with torch.no_grad():
        final = T.lm_loss(state.params, cfg,
                          tl.to_device(data.batch(10_000), state.params))
    print(f"final eval loss {float(final):.3f} "
          f"(uniform {math.log(cfg.vocab_size):.3f}, "
          f"floor ~{data.entropy_floor():.3f}); "
          f"stragglers flagged: {len(mon.events)}")


if __name__ == "__main__":
    main()
