#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``combblas_tpu_torch``) on one NVIDIA GPU.

Phases, each raising on failure:
  1. the card: its name and power limit from nvidia-smi; no CUDA -> exit 1;
  2. build the CUDA kernels from ``combblas_tpu_torch/csrc`` with nvcc;
  3. every kernel of the seg2 path against its plain PyTorch version on the
     card, at the main path's stream sizes (2^26 elements), for PLUS_TIMES,
     MIN_PLUS and MAX_SECOND, plus one saturating output capacity, with
     kernel and plain times from CUDA events;
  4. an independent check: the port's scale-16 SSCA R-MAT A² digest against
     ``scipy.sparse`` on the host;
  5. the main path at full size: scale-22 SSCA ef-8 R-MAT A² through
     ``seg2_prepare`` / ``seg2_step``, every slab, the kernels' launch counts
     read around that run, and three slabs re-run with the plain versions.

The last stdout line is ``{"ok": true, "device": {...}}``, printed only when
every phase passed.  Per-slab details go to ``chiprun_out/chip_smoke.json``.

Usage: python3 chip_smoke.py [--seed 42] [--scale 22] [--check-scale 16]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from combblas_tpu_torch.gen.rmat import SSCA_PROBS, rmat_matrix
from combblas_tpu_torch.ops.kernels import LAUNCHES, _build, reset_launches
from combblas_tpu_torch.ops.kernels import compress as kc
from combblas_tpu_torch.ops.kernels import expand as ke
from combblas_tpu_torch.ops.spgemm import spgemm_flops
from combblas_tpu_torch.ops.spgemm_seg import (
    seg2_prepare,
    seg2_step,
    seg_zero_state,
)
from combblas_tpu_torch.semiring import MAX_SECOND, MIN_PLUS, PLUS_TIMES

SEMIRINGS = (PLUS_TIMES, MIN_PLUS, MAX_SECOND)
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "expand_i32": ("combblas_tpu_torch/csrc/expand.cu",
                   "combblas_tpu/ops/pallas/expand_kernel.py:295"),
    "compress_i32": ("combblas_tpu_torch/csrc/compress.cu",
                     "combblas_tpu/ops/pallas/compress_kernel.py:242"),
    "expand_i64": ("combblas_tpu_torch/csrc/expand.cu",
                   "combblas_tpu/ops/pallas/expand_kernel.py:505"),
    "compress_i64": ("combblas_tpu_torch/csrc/compress.cu",
                     "combblas_tpu/ops/pallas/compress_kernel.py:496"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds per call from CUDA events, after one warm-up."""
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


# ---------------------------------------------------------------- phase 3 --

def _expand_inputs(gen, dev, wide: bool, log2: int):
    """A slab's entries and a B over 2^(log2-4) columns whose product stream
    is ~2^log2 long: B rows of 0..16 entries (mean 8), 2^(log2-3) A
    entries."""
    k = n = 1 << (log2 - 4)
    deg = torch.randint(0, 17, (k,), generator=gen, device=dev)
    b_rp = torch.zeros(k + 1, dtype=torch.int64, device=dev)
    b_rp[1:] = torch.cumsum(deg, 0)
    nb = int(b_rp[-1])
    b_col = torch.randint(0, n, (nb,), generator=gen, device=dev,
                          dtype=torch.int32)
    b_val = torch.rand(nb, generator=gen, device=dev) + 0.5
    na = 1 << (log2 - 3)
    rows = (1 << (log2 - 6)) if wide else (1 << (log2 - 10))
    a_row = torch.sort(torch.randint(0, rows, (na,), generator=gen,
                                     device=dev, dtype=torch.int32))[0]
    a_col = torch.randint(0, k, (na,), generator=gen, device=dev,
                          dtype=torch.int32)
    a_val = torch.rand(na, generator=gen, device=dev) + 0.5
    valid = torch.ones(na, dtype=torch.bool, device=dev)
    return (a_row, a_col, a_val, valid, b_rp, b_col, b_val), n


def check_expand(gen, dev, wide: bool, log2: int = 26) -> dict:
    args, n = _expand_inputs(gen, dev, wide, log2)
    fn = ke.expand_chunks_compact_wide if wide else ke.expand_chunks_compact
    stride = n + 1 if wide else 0
    cap = 1 << (log2 + 1)
    err = 0.0
    for sr in SEMIRINGS:
        key, val, total = fn(*args, sr, stride=stride, stream_cap=cap)
        pkey, pval, ptotal = fn(*args, sr, stride=stride, stream_cap=cap,
                                plain=True)
        t = int(ptotal)
        if int(total) != t or not torch.equal(key, pkey):
            raise AssertionError(f"expand wide={wide} {sr.name}: keys/count "
                                 f"differ ({int(total)} vs {t})")
        if not torch.equal(val.view(torch.int32), pval.view(torch.int32)):
            raise AssertionError(f"expand wide={wide} {sr.name}: values "
                                 "differ")
        err = max(err, float((val - pval).abs().max()))
    # saturating capacity: the first `small` products, the count unclamped
    small = t // 2
    skey, sval, stot = fn(*args, PLUS_TIMES, stride=stride, stream_cap=small)
    if int(stot) != t or not torch.equal(skey, pkey[:small]):
        raise AssertionError(f"expand wide={wide}: saturated run differs")
    ms = cuda_ms(lambda: fn(*args, PLUS_TIMES, stride=stride,
                            stream_cap=cap))
    plain_ms = cuda_ms(lambda: fn(*args, PLUS_TIMES, stride=stride,
                                  stream_cap=cap, plain=True), reps=2)
    log(f"  expand {'i64' if wide else 'i32'}: {t} products, exact for "
        f"{[s.name for s in SEMIRINGS]}; kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, elements=t)


def _compress_inputs(gen, dev, wide: bool, log2: int):
    """A sorted 2^log2-element stream.  Windowed (int32): windows of 1024,
    each sorted with a sentinel tail, ~3 products per output entry.  Flat
    (int64): 2^(log2-6) rows of ~64 products over 48 columns, keyed
    row*(n+1)+col, sorted, sentinel-padded."""
    n_el = 1 << log2
    sent32 = torch.iinfo(torch.int32).max
    if not wide:
        s, w = 1 << (log2 - 10), 1024
        lens = torch.randint(0, w, (s, 1), generator=gen, device=dev)
        span = torch.clamp(lens // 3, min=1)
        keys = (torch.rand((s, w), generator=gen, device=dev) * span).long()
        keys = keys.to(torch.int32) * 4099
        j = torch.arange(w, device=dev)[None, :]
        keys = torch.where(j < lens, keys, sent32)
        keys = torch.sort(keys, dim=1)[0].reshape(-1)
        vals = torch.rand(n_el, generator=gen, device=dev) + 0.25
        return keys, vals, 0
    n = 1 << (log2 - 4)
    nreal = n_el - (1 << (log2 - 6))
    row = torch.sort(torch.randint(0, 1 << (log2 - 6), (nreal,),
                                   generator=gen, device=dev))[0]
    col = torch.randint(0, 48, (nreal,), generator=gen, device=dev)
    keys = torch.full((n_el,), torch.iinfo(torch.int64).max,
                      dtype=torch.int64, device=dev)
    keys[:nreal] = torch.sort(row * (n + 1) + col * (n // 48))[0]
    vals = torch.rand(n_el, generator=gen, device=dev) + 0.25
    return keys, vals, n + 1


def check_compress(gen, dev, wide: bool, log2: int = 26) -> dict:
    """The compress kernel against its plain version.  Keys stay packed, so
    for int64 this is K4 alone; the (row, col) split that
    ``compress_sorted_wide`` adds is timed on its own line."""
    keys, vals, stride = _compress_inputs(gen, dev, wide, log2)
    fn = kc.compress_sorted_wide_keys if wide else kc.compress_sorted_packed
    cap = 1 << log2
    err = 0.0
    for sr in SEMIRINGS:
        gk, gv, gn = fn(keys, vals, sr, out_capacity=cap)
        pk, pv, pn = fn(keys, vals, sr, out_capacity=cap, plain=True)
        nnz = int(pn)
        if int(gn) != nnz or nnz == 0:
            raise AssertionError(f"compress wide={wide} {sr.name}: nnz "
                                 f"{int(gn)} vs {nnz}")
        if not torch.equal(gk, pk):
            raise AssertionError(f"compress wide={wide} {sr.name}: keys "
                                 "differ")
        if sr.add_kind == "sum":
            torch.testing.assert_close(gv, pv, rtol=1e-6, atol=0)
        elif not torch.equal(gv, pv):
            raise AssertionError(f"compress wide={wide} {sr.name}: values "
                                 "differ")
        err = max(err, float((gv - pv).abs().max()))
    small = -(-(nnz // 2) // 128) * 128
    gk, _gv, gn = fn(keys, vals, PLUS_TIMES, out_capacity=small)
    pk, _pv, pn = fn(keys, vals, PLUS_TIMES, out_capacity=small, plain=True)
    if int(gn) != small or int(pn) != small:
        raise AssertionError(f"compress wide={wide}: no saturation at {small}")
    if not torch.equal(gk, pk):
        raise AssertionError(f"compress wide={wide}: saturated keys differ")
    ms = cuda_ms(lambda: fn(keys, vals, PLUS_TIMES, out_capacity=cap))
    plain_ms = cuda_ms(lambda: fn(keys, vals, PLUS_TIMES, out_capacity=cap,
                                  plain=True), reps=2)
    log(f"  compress {'i64' if wide else 'i32'}: {keys.numel()} elements -> "
        f"{nnz}; agree for {[s.name for s in SEMIRINGS]} and saturation at "
        f"{small}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               elements=keys.numel())
    if wide:
        out["with_split_ms"] = cuda_ms(lambda: kc.compress_sorted_wide(
            keys, vals, PLUS_TIMES, out_capacity=cap, stride=stride))
        log(f"  compress i64 with the (row, col) split of "
            f"compress_sorted_wide: {out['with_split_ms']:.3f} ms")
    return out


# ------------------------------------------------------------ phases 4, 5 --

def run_slabs(a, prep, dev, sync_each: bool):
    """Every slab of the digest; with ``sync_each`` one scalar sync per slab
    (its nnz), returning per-slab nnz deltas and seconds."""
    state = seg_zero_state(dev)
    nnz_prev, per_nnz, per_secs = 0, [], []
    for s in range(len(prep[1]["slabs"])):
        ts = time.perf_counter()
        state = seg2_step(a, prep, s, state, PLUS_TIMES)
        if sync_each:
            nnz_now = int(state[0])
            per_secs.append(time.perf_counter() - ts)
            per_nnz.append(nnz_now - nnz_prev)
            nnz_prev = nnz_now
    return state, per_nnz, per_secs


def check_scipy(seed: int, scale: int, dev) -> None:
    import scipy.sparse as sp

    gen = torch.Generator(device=dev).manual_seed(seed)
    a = rmat_matrix(gen, scale, 8, probs=SSCA_PROBS)
    prep = seg2_prepare(a, a, flops_cap=1 << 20, max_widths=20)
    state, _, _ = run_slabs(a, prep, dev, sync_each=False)
    nnz, cks, trunc = int(state[0]), float(state[1]), bool(state[2])
    row, col, val, annz, shape = a.to_numpy()
    s = sp.csr_matrix((val[:annz].astype(np.float64),
                       (row[:annz], col[:annz])), shape=shape)
    c = s @ s
    ref_nnz, ref_cks = int(c.nnz), float(c.sum())
    rel = abs(cks - ref_cks) / abs(ref_cks)
    nw = sum(not sl["flat"] for sl in prep[1]["slabs"])
    log(f"  scale {scale}: {len(prep[1]['slabs'])} slabs ({nw} windowed), "
        f"nnz {nnz} vs scipy {ref_nnz}, checksum {cks!r} vs {ref_cks!r} "
        f"(rel {rel:.2e}), truncated {trunc}")
    if nnz != ref_nnz or trunc or not rel <= 1e-4:
        raise AssertionError("scale-%d digest disagrees with scipy" % scale)


def main_path(seed: int, scale: int, dev, details: dict) -> dict:
    t = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = rmat_matrix(gen, scale, 8, probs=SSCA_PROBS)
    torch.cuda.synchronize()
    gen_secs = time.perf_counter() - t
    t = time.perf_counter()
    flops = spgemm_flops(a, a)
    prep = seg2_prepare(a, a, flops_cap=1 << 28, max_widths=20)
    plan_secs = time.perf_counter() - t
    cfg = prep[1]
    slabs = cfg["slabs"]
    if cfg["flops"] != flops:
        raise AssertionError(f"plan covers {cfg['flops']} of {flops} products")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    state, per_nnz, per_secs = run_slabs(a, prep, dev, sync_each=True)
    secs = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    nnz_c, checksum, truncated = (int(state[0]), float(state[1]),
                                  bool(state[2]))
    n_win = sum(not sl["flat"] for sl in slabs)
    line = dict(
        scale=scale, seed=seed, nnz_a=int(a.nnz), flops=flops,
        slabs=len(slabs), windowed_slabs=n_win, shapes=len(cfg["shapes"]),
        pad_ratio=cfg["pad_ratio"], gen_secs=gen_secs, plan_secs=plan_secs,
        secs=secs, products_per_s=flops / secs, nnz_c=nnz_c,
        checksum=checksum, truncated=truncated,
        expand_launches=launches["expand_i32"] + launches["expand_i64"],
        compress_launches=(launches["compress_i32"]
                           + launches["compress_i64"]),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
    )
    log(json.dumps(line))
    details["slabs"] = [dict(sl, nnz=per_nnz[s], secs=per_secs[s])
                        for s, sl in enumerate(slabs)]
    if truncated or nnz_c <= 0 or not math.isfinite(checksum):
        raise AssertionError("scale-22 digest is truncated or not finite")
    want = {"expand_i32": n_win, "compress_i32": n_win,
            "expand_i64": len(slabs) - n_win,
            "compress_i64": len(slabs) - n_win}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    # three slabs again, kernels and plain versions, each from a zero state
    win = [s for s, sl in enumerate(slabs) if not sl["flat"]]
    flat = [s for s, sl in enumerate(slabs) if sl["flat"]]
    picks = []
    if win:
        picks.append(max(win, key=lambda s: slabs[s]["flops"]))
    picks.append(len(slabs) // 2)
    if flat:
        picks.append(flat[0])
    for s in dict.fromkeys(picks):
        got = seg2_step(a, prep, s, seg_zero_state(dev), PLUS_TIMES)
        ref = seg2_step(a, prep, s, seg_zero_state(dev), PLUS_TIMES,
                        plain=True)
        g_nnz, r_nnz = int(got[0]), int(ref[0])
        g_cks, r_cks = float(got[1]), float(ref[1])
        rel = abs(g_cks - r_cks) / max(abs(r_cks), 1e-30)
        log(f"  slab {s} ({'flat' if slabs[s]['flat'] else 'w=%d' % slabs[s]['w']}"
            f", {slabs[s]['flops']} products): nnz {g_nnz} kernels vs "
            f"{r_nnz} plain (main pass {per_nnz[s]}), checksum rel "
            f"{rel:.2e}")
        if not (g_nnz == r_nnz == per_nnz[s]) or not rel <= 1e-5:
            raise AssertionError(f"slab {s}: kernels and plain versions "
                                 "disagree")
        if bool(got[2]) or bool(ref[2]):
            raise AssertionError(f"slab {s}: truncated")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--check-scale", type=int, default=16)
    args = ap.parse_args()

    # 1. the card
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"phase 1: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    details = {"card": card}

    # 2. build
    t = time.perf_counter()
    _build.library()
    log(f"phase 2: kernels built and loaded in {time.perf_counter() - t:.1f} "
        f"s (nvcc {_build.build_seconds})")
    build_log = _build.BUILD_DIR / "build.log"
    ptx = build_log.read_text().splitlines() if build_log.exists() else []
    details["ptxas"] = [ln for ln in ptx if "registers" in ln or "spill" in ln]
    for ln in details["ptxas"]:
        if "registers" in ln:
            log("  " + ln.strip())

    # 3. kernels vs plain versions
    log("phase 3: kernels vs plain versions at main-path sizes")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    k3 = {"expand_i32": check_expand(gen, dev, wide=False),
          "compress_i32": check_compress(gen, dev, wide=False),
          "expand_i64": check_expand(gen, dev, wide=True),
          "compress_i64": check_compress(gen, dev, wide=True)}
    torch.cuda.empty_cache()

    # 4. independent end-to-end check
    log("phase 4: port digest vs scipy.sparse")
    check_scipy(args.seed, args.check_scale, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # 5. the main path at full size
    log(f"phase 5: scale-{args.scale} A² seg2 digest, every slab")
    launches = main_path(args.seed, args.scale, dev, details)

    kernels = [dict(name=name, route="cuda", source=KERNELS[name][0],
                    replaces=KERNELS[name][1], launches=launches[name],
                    max_abs_err=k3[name]["max_abs_err"], ms=k3[name]["ms"],
                    plain_ms=k3[name]["plain_ms"])
               for name in KERNELS]
    details["kernels"] = kernels
    details["phase3"] = k3
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(details, fh, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
