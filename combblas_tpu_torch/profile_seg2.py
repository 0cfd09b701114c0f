"""Where a seg2 slab's time goes on the GPU.

Builds the scale-``--scale`` SSCA ef-8 R-MAT and its seg2 plan with the
settings of ``chip_smoke.py`` phase 5, runs every slab once (warm-up), then
for a few slabs (the heaviest windowed, a middle windowed, the last
windowed, the largest flat) measures:

- ``wall_ms``: host clock around one ``seg2_step`` with a sync before and
  after, median of ``--reps`` runs without the profiler;
- ``busy_ms``: the union of the device intervals (kernels, memcpy, memset)
  that ``torch.profiler`` records for one more run of the slab.  The union,
  not the sum, so overlapping intervals count once; operator rows
  (``aten::*``) are host-side and never counted;
- ``busy_share = busy_ms / wall_ms`` and the device time per kernel name.

Then one whole pass (every slab, one scalar sync per slab as in
``chip_smoke.py``) under the profiler: the device time summed by kernel
name over the pass, and by stage (:data:`STAGES`: K1/K3's count, split and
expansion kernels, K2/K4's compress and pad kernels, the sorts, the
device-to-device copies, the rest), printed on a line of its own.  That is
K1's and K2's time on the main path at the real slab sizes.

:data:`STAGES` and :func:`split_by_stage` are the one stage split of the
profilers (``profile_spgemm``, ``profile_summa``).

Prints one JSON line per slab and writes everything to
``chiprun_out/profile_seg2.json``.  Needs a CUDA device.

Usage: python3 -m combblas_tpu_torch.profile_seg2 [--seed 42] [--scale 22]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

from combblas_tpu_torch.gen.rmat import SSCA_PROBS, rmat_matrix
from combblas_tpu_torch.ops.spgemm_seg import (
    seg2_prepare,
    seg2_step,
    seg_zero_state,
)


def interval_union_us(spans) -> float:
    """Total length covered by (start, end) intervals, overlaps once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_events(prof):
    """(name, start_us, end_us) of every device-side event of a profile."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == cuda]


#: Stage of a device event, in the profilers' splits: (stage, base names,
#: name parts).  The port's kernels match by their whole base name
#: (:func:`kernel_base`, so ``count_kernel`` is K1's and not any longer name
#: ending in it), library kernels and copies by a part of their name; an
#: event that matches no stage is "other".
STAGES = (
    ("expand", ("count_kernel", "split_kernel", "expand_kernel",
                "expand_chunks_kernel"), ()),
    ("compress", ("compress_kernel", "pad_kernel"), ()),
    ("sort", (), ("RadixSort", "radix_sort")),
    ("assembly", (), ("Memcpy DtoD",)),
)


def kernel_base(name: str) -> str:
    """``void (anonymous namespace)::expand_kernel<int>(int const*, ...)``
    -> ``expand_kernel``."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].split("::")[-1].strip()


def stage_of(name: str, stages=STAGES) -> str:
    """The first of ``stages`` that a device event's name matches."""
    base = kernel_base(name)
    for stage, bases, parts in stages:
        if base in bases or any(p in name for p in parts):
            return stage
    return "other"


def split_by_stage(events, stages=STAGES) -> dict:
    """{stage: {"ms": total, "kernels": {name: ms}}} over (name, start_us,
    end_us) device events, each event in the stage :func:`stage_of` gives."""
    out: dict = {}
    for name, t0, t1 in events:
        st = out.setdefault(stage_of(name, stages),
                            {"ms": 0.0, "kernels": {}})
        ms = (t1 - t0) / 1e3
        st["ms"] += ms
        st["kernels"][name] = st["kernels"].get(name, 0.0) + ms
    return out


def by_name_ms(events) -> dict:
    """Device milliseconds summed by name over (name, start_us, end_us)
    events, largest first."""
    out: dict[str, float] = {}
    for name, t0, t1 in events:
        out[name] = out.get(name, 0.0) + (t1 - t0) / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def pick_slabs(slabs) -> dict:
    win = [s for s, sl in enumerate(slabs) if not sl["flat"]]
    flat = [s for s, sl in enumerate(slabs) if sl["flat"]]
    picks = {}
    if win:
        picks["heaviest_windowed"] = max(win, key=lambda s: slabs[s]["flops"])
        picks["mid_windowed"] = win[len(win) // 2]
        picks["last_windowed"] = win[-1]
    if flat:
        picks["largest_flat"] = max(flat, key=lambda s: slabs[s]["flops"])
    return picks


def profile_slab(a, prep, s: int, dev, reps: int) -> dict:
    def step():
        return seg2_step(a, prep, s, seg_zero_state(dev))

    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    ev = device_events(prof)
    by_name: dict[str, float] = {}
    for name, t0, t1 in ev:
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e3
    wall = statistics.median(walls)
    sl = prep[1]["slabs"][s]
    out = dict(slab=s, w=sl["w"], s_pad=sl["s_pad"], flat=sl["flat"],
               flops=sl["flops"], padded=sl["padded"], wall_ms=wall,
               wall_ms_runs=walls, device_events=len(ev))
    if ev:
        busy = interval_union_us([(t0, t1) for _n, t0, t1 in ev]) / 1e3
        span = (max(t1 for _n, _t0, t1 in ev)
                - min(t0 for _n, t0, _t1 in ev)) / 1e3
        out.update(busy_ms=busy, device_span_ms=span,
                   sum_ms=sum(by_name.values()), busy_share=busy / wall,
                   by_name=dict(sorted(by_name.items(),
                                       key=lambda kv: -kv[1])))
    return out


def profile_pass(a, prep, dev) -> dict:
    """One whole pass under the profiler: device busy time and the device
    time by kernel name and by stage."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        state = seg_zero_state(dev)
        for s in range(len(prep[1]["slabs"])):
            state = seg2_step(a, prep, s, state)
            int(state[0])
        torch.cuda.synchronize()
    ev = device_events(prof)
    names = by_name_ms(ev)
    return dict(device_events=len(ev), nnz_c=int(state[0]),
                busy_ms=interval_union_us([(t0, t1) for _n, t0, t1 in ev])
                / 1e3, sum_ms=sum(names.values()),
                stage_ms={k: v["ms"] for k, v in split_by_stage(ev).items()},
                by_name=names)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_seg2: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    a = rmat_matrix(gen, args.scale, 8, probs=SSCA_PROBS)
    prep = seg2_prepare(a, a, flops_cap=1 << 28, max_widths=20)
    slabs = prep[1]["slabs"]
    state = seg_zero_state(dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for s in range(len(slabs)):
        state = seg2_step(a, prep, s, state)
        int(state[0])  # one scalar sync per slab, as chip_smoke.py's pass
    pass_secs = time.perf_counter() - t
    print(json.dumps(dict(scale=args.scale, seed=args.seed,
                          slabs=len(slabs), pass_secs=pass_secs,
                          nnz_c=int(state[0]))), flush=True)
    whole = profile_pass(a, prep, dev)
    print(json.dumps(dict(
        pass_profile=True, device_events=whole["device_events"],
        busy_ms=whole["busy_ms"], sum_ms=whole["sum_ms"],
        stage_ms=whole["stage_ms"],
        by_name={k[:80]: v for k, v in list(whole["by_name"].items())[:12]})),
        flush=True)
    rows = {}
    for label, s in pick_slabs(slabs).items():
        r = profile_slab(a, prep, s, dev, args.reps)
        rows[label] = r
        top = list(r.get("by_name", {}).items())[:12]
        brief = {k: v for k, v in r.items()
                 if k not in ("by_name", "wall_ms_runs")}
        print(json.dumps(dict(label=label, **brief)), flush=True)
        for name, ms in top:
            print(f"    {ms:9.3f} ms  {name[:100]}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_seg2.json"), "w") as fh:
        json.dump(dict(pass_secs=pass_secs, pass_profile=whole, slabs=rows),
                  fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
