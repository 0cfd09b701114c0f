"""Where the distributed A²'s time goes on the GPU.

Runs the grid products of ``chip_smoke.py`` phases 13-14 (:func:`grid_cells`,
which both use): phase 11's scale-``AUTO_SCALE`` G500 ef-16 R-MAT A² through
``summa_spgemm_auto`` on 2x2 and 4x4 block grids, ``summa_spgemm_staged``
and ``summa_spgemm_rma`` on the 4x4 grid, and ``summa3d_spgemm`` on a
(2, 2, 2) grid, every block on the card.  For each: one warm call (its host
wall, synchronised), then one call under ``torch.profiler``, of which it
reports

- ``busy_ms``: the union of the call's device intervals and ``busy_share =
  busy_ms / wall_ms`` against the warm call's wall;
- device time per stage: the stages of ``profile_seg2.STAGES``
  (``expand``, ``compress``, ``sort``, ``assembly``) plus ``ring`` (K9's
  ``ring_shift_kernel``) and ``scatter`` (``index_add_`` / ``scatter_`` /
  ``index_put_`` kernels: the plain fold of ``compress_sorted`` and the
  block gathers), the rest ``other``; with the kernels of each by name.

Prints JSON lines and writes everything to ``chiprun_out/profile_summa.json``.
Needs a CUDA device.

Usage: python3 -m combblas_tpu_torch.profile_summa [--seed 42]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

import torch

from combblas_tpu_torch.gen.graph500 import AUTO_SCALE, a2_matrix
from combblas_tpu_torch.ops.spgemm import _entry_counts, round_capacity_frac
from combblas_tpu_torch.parallel import exchange
from combblas_tpu_torch.parallel.dist import DistSpMat
from combblas_tpu_torch.parallel.grid import ProcGrid
from combblas_tpu_torch.parallel.memefficient import summa_spgemm_staged
from combblas_tpu_torch.parallel.rma import summa_spgemm_rma
from combblas_tpu_torch.parallel.summa import (
    _layer,
    _panel_stacks,
    _panels,
    summa_bounds,
    summa_chunk_bound,
    summa_flops,
    summa_impl_auto,
    summa_spgemm_auto,
)
from combblas_tpu_torch.parallel.summa3d import Dist3DSpMat, summa3d_spgemm
from combblas_tpu_torch.profile_seg2 import STAGES as SPGEMM_STAGES
from combblas_tpu_torch.profile_seg2 import (
    device_events,
    interval_union_us,
    split_by_stage,
)

#: Sides of the square grids, and the (layers, pr, pc) of the 3D grid.
GRID_SIDES = (2, 4)
GRID3D = (2, 2, 2)
#: The SpGEMM stages, plus K9 and the plain scatter folds.
STAGES = SPGEMM_STAGES + (
    ("ring", ("ring_shift_kernel",), ()),
    ("scatter", (), ("indexFunc", "scatter_gather", "index_put")))


def layer_bounds(a3: Dist3DSpMat, b3: Dist3DSpMat):
    """(flops_cap, out_capacity) of ``summa3d_spgemm`` from each block's
    exact layer-panel count, rounded as ``summa_bounds`` rounds;
    ``summa3d_bounds`` takes the whole product's count, which at scale 17
    would not fit the card.  On a pod each process counts its own blocks'
    panels and the largest count is taken over the processes, so that
    every process gets the same caps."""
    stacks = _panel_stacks(a3, b3)
    worst = 0
    for t, i, j in itertools.product(*map(range,
                                          a3.grid.local_shape3())):
        pa, pb = _panels(a3, b3, i, j, _layer(stacks, t))
        worst = max(worst, int(_entry_counts(pa, pb.row_ptr()).sum()))
    worst = int(exchange.max_proc(torch.tensor(worst), a3.grid))
    cap = round_capacity_frac(worst)
    return cap, cap


def grid_cells(a, dev) -> list:
    """The grid products of A² on ``dev``: (label, call, info) in phase
    order, ``info`` holding the layout: grid, route, caps, the largest
    block's panel products and set-up seconds."""
    cells = []
    grids = {}
    for side in GRID_SIDES:
        t = time.perf_counter()
        da = DistSpMat.from_local(a, ProcGrid.make(side, side, device=dev))
        per_block = summa_flops(da, da)
        grids[side] = da
        cells.append((f"summa_spgemm_auto {side}x{side}",
                      lambda da=da: summa_spgemm_auto(da, da),
                      dict(grid=(side, side), impl=summa_impl_auto(da, da),
                           a_capacity=da.capacity,
                           a_imbalance=float(da.load_imbalance()),
                           block_flops_max=int(per_block.max()),
                           setup_secs=time.perf_counter() - t)))
    d4 = grids[4]
    fc, oc = summa_bounds(d4, d4)
    impl = summa_impl_auto(d4, d4)
    chunk_cap = summa_chunk_bound(d4, d4, fc)
    caps = dict(grid=(4, 4), stage_flops_cap=fc, out_capacity=oc)
    cells.append(("summa_spgemm_staged 4x4",
                  lambda: summa_spgemm_staged(d4, d4, stage_flops_cap=fc,
                                              out_capacity=oc, impl=impl,
                                              chunk_cap=chunk_cap),
                  dict(caps, impl=impl)))
    cells.append(("summa_spgemm_rma 4x4",
                  lambda: summa_spgemm_rma(d4, d4, stage_flops_cap=fc,
                                           out_capacity=oc),
                  dict(caps, impl="xla")))
    t = time.perf_counter()
    g3 = ProcGrid.make(GRID3D[1], GRID3D[2], layers=GRID3D[0], device=dev)
    a3 = Dist3DSpMat.from_dist2d(a, g3, "col")
    b3 = Dist3DSpMat.from_dist2d(a, g3, "row")
    fc3, oc3 = layer_bounds(a3, b3)
    cells.append(("summa3d_spgemm 2x2x2",
                  lambda: summa3d_spgemm(a3, b3, flops_cap=fc3,
                                         out_capacity=oc3),
                  dict(grid=GRID3D, impl="xla", flops_cap=fc3,
                       out_capacity=oc3,
                       setup_secs=time.perf_counter() - t)))
    return cells


def profile_cell(call) -> dict:
    """One warm call's wall, then one profiled call's busy time and device
    time by stage."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    c = call()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    del c
    torch.cuda.empty_cache()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        c = call()
        torch.cuda.synchronize()
    del c
    torch.cuda.empty_cache()
    ev = device_events(prof)
    line = dict(wall_ms=wall, device_events=len(ev))
    stages = split_by_stage(ev, STAGES)
    if ev:
        busy = interval_union_us([(t0, t1) for _n, t0, t1 in ev]) / 1e3
        line.update(busy_ms=busy, busy_share=busy / wall,
                    stage_ms={k: v["ms"] for k, v in stages.items()})
    return dict(line, stages=stages)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_summa: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    a = a2_matrix(args.seed, dev, AUTO_SCALE)
    out = {}
    for label, call, info in grid_cells(a, dev):
        rec = dict(info, **profile_cell(call))
        out[label] = rec
        print(json.dumps(dict({k: v for k, v in rec.items()
                               if k != "stages"}, label=label)), flush=True)
        for stage, st in sorted(rec["stages"].items(),
                                key=lambda kv: -kv[1]["ms"]):
            print(f"  {stage}: {st['ms']:.3f} ms", flush=True)
            for name, ms in sorted(st["kernels"].items(),
                                   key=lambda kv: -kv[1])[:4]:
                print(f"    {ms:9.3f} ms  {name[:100]}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_summa.json"), "w") as fh:
        json.dump(dict(scale=AUTO_SCALE, seed=args.seed, cells=out), fh,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
