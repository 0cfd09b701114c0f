"""Run one cell of ``BENCHMARK.json`` once on the GPU and print its line.

Usage, from the root of a checkout:

    python3 gpubench/run.py --workload a2_keep.ssca20 --seed 1 --seconds 30 --trace 0

Set-up (the kernel library built or loaded, the graph made on the card
from ``--seed``, the program's plans, a warm-up of this cell's shapes) is
``setup_s``; then operations run for ``--seconds``; then the program's
output is held against the plain reference.  The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last the
numbers compared with their limits, which also end standard error).
Exits 1 without a line when there is no CUDA card, fewer cards than the
cell asks for, or when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".gpubench_cache"
# every build and kernel cache at a fixed place inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import combblas_tpu_torch  # noqa: F401  (no program, no result)

    from gpubench.core import manifest
    from gpubench.core.harness import forbidden_modules, run_cell
    bench = manifest.load_benchmark()
    chips = int(manifest.cell(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpubench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    try:
        line, compared, ops = run_cell(args.workload, args.seed,
                                       args.seconds, bool(args.trace), dev,
                                       T0, bench=bench)
    except RuntimeError as exc:
        if "forbidden modules" not in str(exc):
            raise
        print(f"gpubench: {exc}", file=sys.stderr)
        return 1
    print(f"window: {len(ops)} operations; records "
          f"{json.dumps(ops)[:2000]}", file=sys.stderr)
    for name, (value, limit) in compared.items():
        print(f"compared {name}: {value!r} (limit {limit!r})",
              file=sys.stderr)
    found = forbidden_modules()
    if found:   # loaded after the harness's last look: still no result
        print(f"gpubench: forbidden modules loaded: {found}", file=sys.stderr)
        return 1
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
