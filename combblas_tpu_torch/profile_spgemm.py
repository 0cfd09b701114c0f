"""Where a materialized A²'s time goes on the GPU.

Runs ``chip_smoke.py`` phase 11's product: the scale-``AUTO_SCALE`` G500
ef-16 R-MAT A² through ``spgemm_auto`` with ``max_flops_cap =
AUTO_FLOPS_CAP`` (``gen/graph500.py``).  One call finds nnz (estimate and
retry); then, with ``out_capacity = round_capacity_frac(nnz)`` as the phase's
timed call: one warm call, ``REPS`` calls on the host clock (synchronised),
and one call under ``torch.profiler``, of which it reports

- ``busy_ms``: the union of the call's device intervals (kernels, memcpy,
  memset; host-side operator rows never count) and ``busy_share =
  busy_ms / wall_ms`` against the median unprofiled wall;
- device time per stage: ``expand`` (``expand_kernel``), ``sort``
  (``torch.sort``'s radix-sort kernels), ``compress`` (the compress kernels'
  head count and emit), ``assembly`` (device-to-device copies: each slab's
  C block into the output, and any other such copy of the call), and
  ``other`` (fills, aranges, masks, the value gather after the sort, the
  slab plan and extraction), with the kernels of each by name.

Prints JSON lines and writes everything to ``chiprun_out/profile_spgemm.json``.
Needs a CUDA device.

Usage: python3 -m combblas_tpu_torch.profile_spgemm [--seed 42]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

from combblas_tpu_torch.gen.graph500 import (
    AUTO_FLOPS_CAP,
    AUTO_SCALE,
    a2_matrix,
)
from combblas_tpu_torch.ops.spgemm import (
    round_capacity_frac,
    spgemm_auto,
    spgemm_flops,
)
from combblas_tpu_torch.profile_seg2 import device_events, interval_union_us

#: Timed calls without the profiler.
REPS = 3
#: Stage of a device kernel: the first stage one of whose name parts the
#: kernel's name contains; "other" when none does.
STAGES = (("expand", ("expand_kernel",)),
          ("compress", ("head_count_kernel", "emit_kernel")),
          ("sort", ("RadixSort", "radix_sort")),
          ("assembly", ("Memcpy DtoD",)))


def stage_of(name: str, stages=STAGES) -> str:
    for stage, parts in stages:
        if any(p in name for p in parts):
            return stage
    return "other"


def split_by_stage(events, stages=STAGES) -> dict:
    """{stage: {"ms": total, "kernels": {name: ms}}} over (name, start_us,
    end_us) device events, each kernel in the first of ``stages`` whose name
    parts it contains."""
    out: dict = {}
    for name, t0, t1 in events:
        st = out.setdefault(stage_of(name, stages),
                            {"ms": 0.0, "kernels": {}})
        ms = (t1 - t0) / 1e3
        st["ms"] += ms
        st["kernels"][name] = st["kernels"].get(name, 0.0) + ms
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_spgemm: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    a = a2_matrix(args.seed, dev, AUTO_SCALE)
    flops = spgemm_flops(a, a)
    c = spgemm_auto(a, a, max_flops_cap=AUTO_FLOPS_CAP)
    tight = round_capacity_frac(int(c.nnz))
    del c

    def call():
        out = spgemm_auto(a, a, max_flops_cap=AUTO_FLOPS_CAP,
                          out_capacity=tight)
        return int(out.nnz)                       # scalar sync

    nnz = call()                                  # warm
    walls = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    ev = device_events(prof)
    wall = statistics.median(walls)
    line = dict(scale=AUTO_SCALE, seed=args.seed, nnz_a=int(a.nnz),
                flops=flops, nnz_c=nnz, out_capacity=tight, wall_ms=wall,
                wall_ms_runs=walls, products_per_s=flops / (wall / 1e3),
                device_events=len(ev))
    stages = split_by_stage(ev)
    if ev:
        busy = interval_union_us([(t0, t1) for _n, t0, t1 in ev]) / 1e3
        line.update(busy_ms=busy, busy_share=busy / wall,
                    stage_ms={k: v["ms"] for k, v in stages.items()})
    print(json.dumps(line), flush=True)
    for stage, st in sorted(stages.items(), key=lambda kv: -kv[1]["ms"]):
        print(f"  {stage}: {st['ms']:.3f} ms", flush=True)
        for name, ms in sorted(st["kernels"].items(),
                               key=lambda kv: -kv[1])[:6]:
            print(f"    {ms:9.3f} ms  {name[:100]}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_spgemm.json"), "w") as fh:
        json.dump(dict(line, stages=stages), fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
