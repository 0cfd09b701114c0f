"""The streamed A²: ``spgemm_streamed_seg(A, A, prep=prep)`` called again
and again, the classed digest's plan (``seg_prepare``) built once in
set-up from A's structure, nothing else held across calls; each call
forms C one row slab at a time and folds it into the digest (nnz,
float32 checksum, truncated, float32 sum with odd columns negated), ended
by the call's own reads of it.  The last digest is held against the plain
one."""

from __future__ import annotations

import zlib

import torch

from combblas_tpu_torch.ops.kernels import LAUNCHES
from combblas_tpu_torch.ops.spgemm_seg import seg_prepare, spgemm_streamed_seg
from gpubench.count.work import a2_products
from gpubench.drivers._program import graphs, program_starts, to_spcoo
from gpubench.ref.a2_digest import a2_digest, compare_digest


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, dev):
        self.g = g = graphs(cfg, mix, seed, dev)[0]
        self.limits = mix["limits"]
        self.counts = {"nnz_a": g.nnz,
                       "products": a2_products(g.row_ptr, g.col)}
        program_starts(dev)
        self.a = to_spcoo(g)
        self.prep = seg_prepare(self.a, self.a,
                                int(cfg["settings"]["num_slabs"]))
        plan = self.prep[0]
        # the plan's padded size a slab and its slabs (a2s.pad_ratio), and
        # a fingerprint of its bounds, to see whether a run moves them
        self.plan = {"padded": plan["padded"],
                     "slabs": len(plan["bounds"]) - 1,
                     "bounds_crc": zlib.crc32(plan["bounds"].tobytes())}
        self.last = None

    def warm(self) -> None:
        self.last = spgemm_streamed_seg(self.a, self.a, prep=self.prep)

    def op(self, i: int, trace: bool) -> dict:
        k1, k2 = LAUNCHES["expand_i32"], LAUNCHES["compress_i32"]
        self.last = spgemm_streamed_seg(self.a, self.a, prep=self.prep)
        return {"products": self.counts["products"], **self.plan,
                "k1_launches": LAUNCHES["expand_i32"] - k1,
                "k2_launches": LAUNCHES["compress_i32"] - k2}

    def release(self) -> None:
        self.a = self.prep = None

    def compare(self) -> dict:
        out = compare_digest(self.g, *self.last)
        self.counts["nnz_c"] = out.pop("nnz_c")
        return {k: (v, self.limits[k]) for k, v in out.items()}


def control(g, cfg: dict, mix: dict, seed: int, dev) -> dict:
    """The control's compared numbers: the plain digest in bfloat16
    (values, products, each entry's fold and each block's sums) in the
    program's place."""
    nnz, checksum, signed, _sumsq = a2_digest(g, dtype=torch.bfloat16)
    out = compare_digest(g, nnz, checksum, False, signed)
    out.pop("nnz_c")
    return out
