"""Where the SpMM and BFS time goes on the GPU.

Builds the data of ``chip_smoke.py`` phases 6-8 (``gen/graph500.py``: a
scale-21 G500 ef-16 R-MAT, its symmetrized loop-free twin, X, the BFS-like
frontier and the 64 roots) and measures:

- the ELL kernel's tail: one warp walks each 8-row group, so the longest
  groups may end the kernel alone.  For the SpMM plan (nb = 1, sum,
  d = 128) and the BFS plan (nb = 6, relabeled, max, d = 128) it times the
  kernel on the whole plan (``full_ms``), with the runs of the 64
  longest groups emptied (``bulk_ms``), and on those groups alone
  (``tail_ms``); CUDA events, mean of 5 after a warm-up;
- one 64-root ``bfs_batch_pull_big`` batch: host wall (median of 3
  batches, sync before and after), and under ``torch.profiler``
  the device busy time (union of device intervals, as in
  ``profile_seg2.py``), busy share and device time per kernel name.

Prints one JSON line per measurement and writes everything to
``chiprun_out/profile_spmm_bfs.json``.  Needs a CUDA device.

Usage: python3 -m combblas_tpu_torch.profile_spmm_bfs [--seed 42]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

from combblas_tpu_torch.gen.graph500 import (
    GRAPH_SCALE,
    bfs_frontier,
    bfs_roots,
    spmm_bfs_graphs,
)
from combblas_tpu_torch.models.bfs import bfs_batch_pull_big
from combblas_tpu_torch.ops.kernels.ell import ell_fold
from combblas_tpu_torch.ops.spmm_ell_blocked import ell_blocked_prepare
from combblas_tpu_torch.profile_seg2 import device_events, interval_union_us

#: Groups in the tail split, and timed batches behind the wall median.
TAIL_GROUPS = 64
BFS_REPS = 3


def split_runs(run_len: torch.Tensor, k: int):
    """(bulk, tail) run tables: ``run_len`` with the runs of its ``k``
    longest groups emptied, and with only those groups' runs kept."""
    group_len = run_len.sum(1)
    top = torch.topk(group_len, min(k, group_len.numel())).indices
    in_tail = torch.zeros(group_len.numel(), dtype=torch.bool,
                          device=run_len.device)
    in_tail[top] = True
    zero = torch.zeros_like(run_len)
    return (torch.where(in_tail[:, None], zero, run_len).contiguous(),
            torch.where(in_tail[:, None], run_len, zero).contiguous())


def _events_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ell_tail(label: str, prep: dict, x: torch.Tensor, op: str) -> dict:
    cols, vals = prep["cols"].t(), prep["vals"].t()
    bulk, tail = split_runs(prep["run_len"], TAIL_GROUPS)
    group_len = prep["run_len"].sum(1)

    def run(run_len):
        return lambda: ell_fold(cols, vals, prep["run_start"], run_len, x,
                                bs_c=prep["bs_c"], op=op)

    return dict(label=label, groups=group_len.numel(),
                mean_group_positions=float(group_len.float().mean()),
                tail_groups=TAIL_GROUPS,
                tail_positions=int(tail.sum()),
                longest_group_positions=int(group_len.max()),
                full_ms=_events_ms(run(prep["run_len"])),
                bulk_ms=_events_ms(run(bulk)), tail_ms=_events_ms(run(tail)))


def profile_bfs(s, prep: dict, roots) -> dict:
    def batch():
        return bfs_batch_pull_big(s, roots, prep=prep)

    batch()
    walls = []
    for _ in range(BFS_REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        batch()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        batch()
        torch.cuda.synchronize()
    ev = device_events(prof)
    by_name: dict[str, float] = {}
    for name, t0, t1 in ev:
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e3
    wall = statistics.median(walls)
    out = dict(roots=len(roots), wall_ms=wall, wall_ms_runs=walls,
               device_events=len(ev))
    if ev:
        busy = interval_union_us([(t0, t1) for _n, t0, t1 in ev]) / 1e3
        out.update(busy_ms=busy, busy_share=busy / wall,
                   by_name=dict(sorted(by_name.items(),
                                       key=lambda kv: -kv[1])))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_spmm_bfs: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(dict(card=card, scale=GRAPH_SCALE, seed=args.seed)),
          flush=True)
    g = spmm_bfs_graphs(args.seed, dev)
    s = g["s"]
    spmm_prep = ell_blocked_prepare(g["a"], 1)
    bfs_prep = ell_blocked_prepare(s, 6, relabel_cols=True, binary=True)
    f = bfs_frontier(bfs_prep["n_pad"], s.shape[0], dev)
    rows = [ell_tail("spmm nb=1 sum d=128", spmm_prep, g["x"], "sum"),
            ell_tail("bfs nb=6 max d=128", bfs_prep, f, "max")]
    for r in rows:
        print(json.dumps(r), flush=True)
    bfs = profile_bfs(s, bfs_prep, bfs_roots(s, args.seed))
    print(json.dumps({k: v for k, v in bfs.items() if k != "by_name"}),
          flush=True)
    for name, ms in list(bfs.get("by_name", {}).items())[:10]:
        print(f"    {ms:9.3f} ms  {name[:100]}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_spmm_bfs.json"),
              "w") as fh:
        json.dump(dict(card=card, scale=GRAPH_SCALE, seed=args.seed, ell=rows,
                       bfs=bfs), fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
