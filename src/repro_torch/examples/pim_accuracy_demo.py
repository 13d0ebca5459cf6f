"""Center+Offset vs Zero+Offset on a trained classifier (Table 4's
mechanism, ``repro_torch.paper.table4_accuracy``: its fidelity metric
through the static-slicing kernel, speculation and accuracy through the
speculative one).

    python -m repro_torch.examples.pim_accuracy_demo [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.paper import table4_accuracy


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    res = table4_accuracy.run(device=ap.parse_args(argv).device)
    for k, v in res.items():
        print(k, v)
    return res


if __name__ == "__main__":
    main()
