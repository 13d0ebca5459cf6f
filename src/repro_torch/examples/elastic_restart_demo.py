"""Fault tolerance demo: inject a failure mid-training, watch the job
restore from the last async checkpoint and finish.

  python -m repro_torch.examples.elastic_restart_demo [--device cpu]

Checkpoints go to a temporary directory that is removed at the end.
"""

import argparse
import tempfile

from repro_torch import configs, resolve_device
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.train import fault_tolerance as ft
from repro_torch.train import optimizer as opt


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = configs.get("qwen1.5-0.5b").reduced(vocab_size=128)
    opt_cfg = opt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60)
    crashed = {"done": False}

    def injector(step):
        if step == 25 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("injected: host 7 lost")

    def data(start):
        return SyntheticLM(vocab_size=128, seq_len=32, batch_size=8,
                           seed=3).iterator(start)

    with tempfile.TemporaryDirectory() as d:
        state = ft.resilient_train(cfg, opt_cfg, data, num_steps=50,
                                   ckpt_dir=d, ckpt_every=10,
                                   fail_injector=injector, device=dev)
    print(f"survived injected failure; finished at step {state.step}")


if __name__ == "__main__":
    main()
