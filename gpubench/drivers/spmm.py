"""Y = A X through ``spmm(A, X, use_kernel=True, prep=...)``, the ELL plan
built in set-up, X (n, d) uniform in [0, 1) from the seed; the last Y is
held against the plain product in float64."""

from __future__ import annotations

import torch

from combblas_tpu_torch.ops.spmm_ell import spmm_ell_prepare
from combblas_tpu_torch.ops.spmv import spmm
from gpubench.drivers._program import graphs, program_starts, to_spcoo
from gpubench.ref.spmm import compare_spmm
from gpubench.ref.spmm import spmm as spmm_ref


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, dev):
        self.g = g = graphs(cfg, mix, seed, dev)[0]
        d = int(mix["d"])
        self.limits = mix["limits"]
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        self.x = torch.rand((g.n, d), generator=gen, device=dev)
        self.counts = {"nnz": g.nnz, "n": g.n, "d": d}
        program_starts(dev)
        self.a = to_spcoo(g)
        self.prep = spmm_ell_prepare(self.a)
        self.y = None

    def warm(self) -> None:
        self.y = spmm(self.a, self.x, use_kernel=True, prep=self.prep)

    def op(self, i: int, trace: bool) -> dict:
        self.y = None
        self.y = spmm(self.a, self.x, use_kernel=True, prep=self.prep)
        return {}

    def release(self) -> None:
        self.a = self.prep = None

    def compare(self) -> dict:
        g = self.g
        out = compare_spmm(g, self.x, self.y)
        return {k: (v, self.limits[k]) for k, v in out.items()}


def control(g, cfg: dict, mix: dict, seed: int, dev) -> dict:
    """The control's compared numbers: the plain product with A and X in
    bfloat16 (products too, summed in float32) in the program's place."""
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    x = torch.rand((g.n, int(mix["d"])), generator=gen, device=dev)
    return compare_spmm(g, x, spmm_ref(g, x, dtype=torch.bfloat16,
                                       acc=torch.float32))
