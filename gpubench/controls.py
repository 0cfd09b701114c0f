"""Readings that set a cell's limits: the program's and the control's.

    python3 gpubench/controls.py --workload spmm128.g500 --seeds 1 2 3 --control-seeds 1 2 3

For each of ``--seeds``: the cell's driver set up from the seed, one
operation of the timed path after its warm-up, and the numbers ``run.py``
compares.  For each of ``--control-seeds``: on the graph scrambled by the
seed, the control (each driver's ``control``: the plain reference
computed in the next precision below the configuration's, bfloat16 for
its float32, put in the program's place) held against the same numbers.
One JSON line per reading; the limits in ``gpubench/traffic/*.json`` are
set between the two.  Runs on the card; ``--cpu --scale N`` rehearses
it.  The benchmark's own runs never run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from gpubench.core import manifest  # noqa: E402
from gpubench.gen.rmat import make_graph  # noqa: E402

__all__ = ["program_numbers"]


def program_numbers(drv_mod, cfg: dict, mix: dict, seed: int, dev) -> dict:
    """The compared numbers of one operation of the timed path (the
    run's first operation, after the warm-up)."""
    drv = drv_mod.Driver(cfg, mix, seed, dev)
    drv.warm()
    drv.op(0, False)
    drv.release()
    return {k: v for k, (v, _lim) in drv.compare().items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--scale", type=int, default=None)
    args = ap.parse_args(argv)
    bench = manifest.load_benchmark()
    cell = manifest.cell(bench, args.workload)
    cfg = manifest.config(bench, cell["config"])
    if args.scale is not None:
        cfg = dict(cfg, graph=dict(cfg["graph"], scale=args.scale))
    mix = manifest.traffic(cell["traffic"])
    if args.cpu:
        dev = torch.device("cpu")
    elif torch.cuda.is_available():
        dev = torch.device("cuda", 0)
        from combblas_tpu_torch.ops.kernels import _build
        _build.library()
    else:
        print("controls: no CUDA card (use --cpu to rehearse)",
              file=sys.stderr)
        return 1
    kind = ("card " + torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    for what, seeds in (("program", args.seeds),
                        ("control", args.control_seeds)):
        for seed in seeds:
            t = time.perf_counter()
            if what == "program":
                nums = program_numbers(manifest.driver(mix["driver"]), cfg,
                                       mix, seed, dev)
            else:
                nums = manifest.driver(mix["driver"]).control(
                    make_graph(cfg["graph"], seed, dev), cfg, mix, seed, dev)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            print(json.dumps({"workload": args.workload, "reading": what,
                              "seed": seed, "numbers": nums, "device": kind,
                              "secs": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
