"""Training launcher of the port.

  python -m repro_torch.launch.train --arch qwen1.5-0.5b --steps 100 \
      --reduced --ckpt-dir ckpt/

Runs on the CUDA card unless ``--device cpu`` is given (without a card the
default device raises). ``--reduced`` trains the smoke-scale config;
without it the published config is built. The data is
``data.pipeline.SyntheticLM`` over the model's vocabulary, whose dense
transition matrix takes ``8 * vocab**2`` bytes of host memory: 185 GB at
qwen1.5-0.5b's 151,936 tokens, so the published qwen config does not start
on a host with less (the reference's launcher has the same limit).
``--ckpt-dir`` saves the state every ``--ckpt-every`` steps on a
background thread; ``--resilient`` (which needs ``--ckpt-dir``) wraps the
loop with checkpoint/restart (``train.fault_tolerance.resilient_train``).
A straggler monitor always runs.
"""

from __future__ import annotations

import argparse

from repro_torch import configs, resolve_device
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import fault_tolerance as ft
from repro_torch.train import optimizer as opt
from repro_torch.train import train_loop as tl


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(configs.REGISTRY))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resilient", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' trains with "
                         "the CPU's PyTorch ops)")
    args = ap.parse_args(argv)
    if args.resilient and not args.ckpt_dir:
        raise SystemExit("--resilient requires --ckpt-dir")
    dev = resolve_device(args.device)

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opt_cfg = opt.AdamWConfig(lr=args.lr, warmup_steps=10,
                              total_steps=args.steps,
                              state_dtype=cfg.opt_state_dtype)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                       batch_size=args.batch, seed=0)
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"{args.steps} steps, loss floor ~{data.entropy_floor():.3f}")
    if args.resilient:
        state = ft.resilient_train(
            cfg, opt_cfg, lambda s: data.iterator(s),
            num_steps=args.steps, ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every, device=dev)
    else:
        hooks = [ft.StragglerMonitor().hook()]
        saver = ckpt.AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir \
            else None
        if saver is not None:
            hooks.append(lambda st, m, dt: (
                saver.save(st.step, (st.params, st.opt_state))
                if st.step % args.ckpt_every == 0 else None))
        state = tl.train(cfg, opt_cfg, data.iterator(0),
                         num_steps=args.steps, hooks=hooks, device=dev)
        if saver is not None:
            saver.wait()
    print(f"done at step {state.step}")


if __name__ == "__main__":
    main()
