"""Where the SpMM and BFS time goes on the GPU.

Builds the data of ``chip_smoke.py`` phases 6-8 (``gen/graph500.py``: a
scale-21 G500 ef-16 R-MAT, its symmetrized loop-free twin, X, the BFS-like
frontier and the 64 roots) and measures:

- the kernels' tails: the longest groups (ELL) and rows (COO) are the
  work a split must spread over the card.  For the SpMM plan (nb = 1, sum,
  d = 128), the BFS plan (nb = 6, relabeled, max, d = 128) and K8 on the
  SpMM matrix (d = 128) it times the kernel on the whole input
  (``full_ms``), with the 64 longest groups' runs or rows emptied
  (``bulk_ms``), and on those alone (``tail_ms``), each on its own piece
  table (ELL; K8 needs none); CUDA events, mean of 5 after a warm-up.
  ``full_ms`` near ``bulk_ms`` means the longest group or row no longer
  sets the kernel's time;
- the piece length L: every kernel shape of ``chip_smoke.py`` phase 6
  (ELL sum nb = 1 and 6, ELL max nb = 6 and 1, K8; d = 128 and d = 8),
  and the ELL sum and max at d = 128 on the graphs of ``SMALL_SCALES``
  (``bench.py``'s SpMM/BFS scales), on the whole input at each L in
  ``SWEEP`` and at the default (ELL: a piece table per L, built outside
  the timing); on the small graphs also the device time of each pass
  (``torch.profiler``, one call per L);
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
from combblas_tpu_torch.ops.kernels.ell import (
    ell_fold,
    ell_pieces,
    piece_len_for,
)
from combblas_tpu_torch.ops.spmm_ell_blocked import ell_blocked_prepare
from combblas_tpu_torch.ops.spmm_kernel import PIECE_LEN as COO_PIECE_LEN
from combblas_tpu_torch.ops.spmm_kernel import _spmm_coo
from combblas_tpu_torch.profile_seg2 import device_events, interval_union_us

#: Groups (rows) in the tail split, timed batches behind the wall median,
#: and the piece lengths of the sweep.
TAIL_GROUPS = 64
BFS_REPS = 3
SWEEP = (64, 96, 128, 192, 256, 384, 512, 768, 1024, 2048, 4096)
#: R-MAT scales of the small graphs of the sweep.
SMALL_SCALES = (16, 18)


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


def split_rows(row_ptr: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
               k: int):
    """(bulk, tail) CSR streams (row_ptr, col, val): the ``k`` longest
    rows emptied, and only those rows kept."""
    deg = row_ptr[1:] - row_ptr[:-1]
    m = deg.numel()
    top = torch.topk(deg, min(k, m)).indices
    in_tail = torch.zeros(m, dtype=torch.bool, device=deg.device)
    in_tail[top] = True
    row_of = torch.repeat_interleave(torch.arange(m, device=deg.device), deg,
                                     output_size=col.numel())

    def keep(rows):
        rp = torch.zeros_like(row_ptr)
        rp[1:] = torch.cumsum(torch.where(rows, deg, 0), 0)
        e = rows[row_of]
        return rp, col[e].contiguous(), val[e].contiguous()

    return keep(~in_tail), keep(in_tail)


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


def _ell_run(prep: dict, x: torch.Tensor, op: str, run_len=None,
             piece_len: int | None = None):
    """A call of the ELL kernel on ``prep`` (its runs, or ``run_len``), its
    piece table built here, outside the call."""
    run_len = prep["run_len"] if run_len is None else run_len
    pieces = ell_pieces(prep["run_start"], run_len, piece_len)
    return lambda: ell_fold(prep["cols"].t(), prep["vals"].t(),
                            prep["run_start"], run_len, x, bs_c=prep["bs_c"],
                            op=op, pieces=pieces)


def _coo_stream(a):
    nnz = int(a.nnz)
    return (a.row_ptr(), a.col[:nnz].contiguous(),
            a.val[:nnz].float().contiguous())


def _coo_run(stream, x: torch.Tensor, piece_len: int = COO_PIECE_LEN):
    return lambda: _spmm_coo(*stream, x, plain=False, piece_len=piece_len)


def ell_tail(label: str, prep: dict, x: torch.Tensor, op: str) -> dict:
    bulk, tail = split_runs(prep["run_len"], TAIL_GROUPS)
    group_len = prep["run_len"].sum(1)

    def run(run_len):
        return _ell_run(prep, x, op, run_len)

    pieces = prep["pieces"]
    return dict(label=label, groups=group_len.numel(),
                mean_group_positions=float(group_len.float().mean()),
                tail_groups=TAIL_GROUPS,
                tail_positions=int(tail.sum()),
                longest_group_positions=int(group_len.max()),
                piece_len=pieces.piece_len, pieces=pieces.table.shape[0],
                split_groups=int((pieces.folds[:, 2] > 0).sum()),
                full_ms=_events_ms(run(prep["run_len"])),
                bulk_ms=_events_ms(run(bulk)), tail_ms=_events_ms(run(tail)))


def coo_tail(label: str, a, x: torch.Tensor) -> dict:
    full = _coo_stream(a)
    bulk, tail = split_rows(*full, TAIL_GROUPS)
    deg = full[0][1:] - full[0][:-1]
    return dict(label=label, rows=deg.numel(), nnz=full[1].numel(),
                tail_rows=TAIL_GROUPS, tail_entries=int(tail[1].numel()),
                longest_row_entries=int(deg.max()), piece_len=COO_PIECE_LEN,
                split_rows=int((deg > COO_PIECE_LEN).sum()),
                full_ms=_events_ms(_coo_run(full, x)),
                bulk_ms=_events_ms(_coo_run(bulk, x)),
                tail_ms=_events_ms(_coo_run(tail, x)))


def pass_ms(fn) -> dict:
    """Device ms of each kernel of one warm call, by kernel name (pass 1 is
    ``ell_kernel``, pass 2 ``ell_combine_kernel``)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for name, t0, t1 in device_events(prof):
        key = "combine" if "combine" in name else (
            "pass1" if "ell_kernel" in name else "other")
        out[key] = out.get(key, 0.0) + (t1 - t0) / 1e3
    return out


def _ell_sweep(label: str, prep: dict, x: torch.Tensor, op: str,
               passes: bool) -> dict:
    group_len = prep["run_len"].sum(1)
    positions = int(group_len.sum())
    out = dict(label=label, positions=positions,
               longest_group_positions=int(group_len.max()),
               default_piece_len=piece_len_for(positions),
               sweep_ms={n or "default": _events_ms(_ell_run(prep, x, op,
                                                             piece_len=n))
                         for n in (*SWEEP, None)})
    if passes:
        out["pass_ms"] = {n: pass_ms(_ell_run(prep, x, op, piece_len=n))
                          for n in SWEEP}
    return out


def sweep(g: dict, spmm_preps: dict, bfs_preps: dict, f: torch.Tensor,
          seed: int) -> list:
    """ms of each phase-6 kernel shape, and of the ELL folds on the small
    graphs, at each piece length of ``SWEEP`` and at the default (None)."""
    f8 = f[:, :8].contiguous()
    stream = _coo_stream(g["a"])
    ell = [("ell_sum nb=1 d=128", spmm_preps[1], g["x"], "sum"),
           ("ell_sum nb=6 d=128", spmm_preps[6], g["x"], "sum"),
           ("ell_sum nb=1 d=8", spmm_preps[1], g["x8"], "sum"),
           ("ell_max nb=6 d=128", bfs_preps[6], f, "max"),
           ("ell_max nb=1 d=128", bfs_preps[1], f, "max"),
           ("ell_max nb=6 d=8", bfs_preps[6], f8, "max")]
    out = [_ell_sweep(*shape, passes=False) for shape in ell]
    for scale in SMALL_SCALES:
        small = spmm_bfs_graphs(seed, f.device, scale)
        s6 = ell_blocked_prepare(small["s"], 6, relabel_cols=True,
                                 binary=True)
        sf = bfs_frontier(s6["n_pad"], small["s"].shape[0], f.device)
        out += [_ell_sweep(f"scale {scale} ell_sum nb=1 d=128",
                           ell_blocked_prepare(small["a"], 1), small["x"],
                           "sum", passes=True),
                _ell_sweep(f"scale {scale} ell_max nb=6 d=128", s6, sf, "max",
                           passes=True)]
    out += [dict(label=f"spmm_coo d={x.shape[1]}",
                 default_piece_len=COO_PIECE_LEN,
                 sweep_ms={n or "default": _events_ms(
                     _coo_run(stream, x, n or COO_PIECE_LEN))
                     for n in (*SWEEP, None)})
            for x in (g["x"], g["x8"])]
    return out


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
    spmm_preps = {nb: ell_blocked_prepare(g["a"], nb) for nb in (1, 6)}
    bfs_preps = {nb: ell_blocked_prepare(s, nb, relabel_cols=True,
                                         binary=True) for nb in (6, 1)}
    bfs_prep = bfs_preps[6]
    f = bfs_frontier(bfs_prep["n_pad"], s.shape[0], dev)
    rows = [ell_tail("spmm nb=1 sum d=128", spmm_preps[1], g["x"], "sum"),
            ell_tail("bfs nb=6 max d=128", bfs_prep, f, "max"),
            coo_tail("spmm_coo d=128", g["a"], g["x"])]
    for r in rows:
        print(json.dumps(r), flush=True)
    sweeps = sweep(g, spmm_preps, bfs_preps, f, args.seed)
    for r in sweeps:
        print(json.dumps(r), flush=True)
    bfs = profile_bfs(s, bfs_prep, bfs_roots(s, args.seed))
    print(json.dumps({k: v for k, v in bfs.items() if k != "by_name"}),
          flush=True)
    for name, ms in list(bfs.get("by_name", {}).items())[:10]:
        print(f"    {ms:9.3f} ms  {name[:100]}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_spmm_bfs.json"),
              "w") as fh:
        json.dump(dict(card=card, scale=GRAPH_SCALE, seed=args.seed,
                       kernels=rows, sweep=sweeps, bfs=bfs), fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
