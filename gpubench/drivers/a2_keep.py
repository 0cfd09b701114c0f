"""The kept-C A²: ``spgemm_auto(A, A, max_flops_cap=...)`` called again and
again with no plan held across calls, each C released before the next
call, the operands cycling through the mix's labellings; the last C is
held against the plain product."""

from __future__ import annotations

import torch

from combblas_tpu_torch.ops.spgemm import spgemm_auto
from gpubench.count.work import a2_products
from gpubench.drivers._program import graphs, program_starts, to_spcoo
from gpubench.ref.spgemm import a2_block, compare_a2, compare_blocks


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, dev):
        self.graphs = graphs(cfg, mix, seed, dev)
        self.cap = int(cfg["settings"]["max_flops_cap"])
        self.limits = mix["limits"]
        g = self.graphs[0]
        # every labelling has the same entries and products
        self.counts = {"nnz_a": g.nnz,
                       "products": a2_products(g.row_ptr, g.col)}
        program_starts(dev)
        self.a = [to_spcoo(g) for g in self.graphs]
        self.last = None

    def warm(self) -> None:
        spgemm_auto(self.a[0], self.a[0], max_flops_cap=self.cap)

    def op(self, i: int, trace: bool) -> dict:
        a = self.a[i % len(self.a)]
        self.last = None
        self.last = (i % len(self.a),
                     spgemm_auto(a, a, max_flops_cap=self.cap))
        return {"products": self.counts["products"]}

    def release(self) -> None:
        self.a = None

    def compare(self) -> dict:
        j, c = self.last
        out = compare_a2(self.graphs[j], c.row, c.col, c.val, int(c.nnz))
        self.counts["nnz_c"] = out.pop("nnz_c")
        return {k: (v, self.limits[k]) for k, v in out.items()}


def control(g, cfg: dict, mix: dict, seed: int, dev) -> dict:
    """The control's compared numbers: the plain A² in bfloat16 (values,
    products and sums) in the program's place, block by block."""
    mismatch, worst, _ = compare_blocks(
        g, lambda r0, r1: a2_block(g, r0, r1, dtype=torch.bfloat16))
    return {"key_mismatch": mismatch, "val_max_rel": worst}
