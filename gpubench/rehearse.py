"""Rehearse one cell on the CPU at a tiny scale (not a measurement).

    python3 gpubench/rehearse.py --workload bfs64.g500 --scale 10 --seconds 1

Runs the same set-up, window, check and metric readers as ``run.py``, on
CPU tensors (the program's kernels then run their plain PyTorch
versions) and on a graph of 2**scale vertices.  The line it prints says
``"platform": "cpu"``: its times are no device numbers.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from gpubench.core.harness import run_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--scale", type=int, default=10)
    args = ap.parse_args(argv)
    line, _, _ = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), torch.device("cpu"), T0,
                       scale=args.scale)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
