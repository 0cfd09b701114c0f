"""HipMCL's job: whole ``mcl_local`` clusterings, one after another, with
the configuration's parameters, the input cycling through the mix's
labellings of the graph; the last clustering's labels and iteration
count are held against the plain MCL.  Set-up warms the shapes with a
clustering cut to ``warm_iters`` iterations."""

from __future__ import annotations

import dataclasses

import torch

from combblas_tpu_torch.models.mcl import MCLParams, mcl_local
from gpubench.drivers._program import graphs, program_starts, to_spcoo
from gpubench.ref.mcl import compare_mcl, mcl


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, dev):
        self.graphs = graphs(cfg, mix, seed, dev)
        self.p = dict(cfg["settings"]["mcl"])
        self.limits = mix["limits"]
        self.warm_iters = int(mix["warm_iters"])
        self.params = MCLParams(**self.p)
        self.counts = {"nnz": self.graphs[0].nnz, "n": self.graphs[0].n}
        program_starts(dev)
        self.a = [to_spcoo(g) for g in self.graphs]
        self.last = None

    def warm(self) -> None:
        mcl_local(self.a[0], dataclasses.replace(self.params,
                                                 max_iters=self.warm_iters))

    def op(self, i: int, trace: bool) -> dict:
        j = i % len(self.a)
        self.last = None
        self.last = (j, *mcl_local(self.a[j], self.params))
        return {"iterations": int(self.last[2])}

    def release(self) -> None:
        self.a = None

    def compare(self) -> dict:
        j, labels, it = self.last
        out = compare_mcl(self.graphs[j], self.p, labels, it)
        return {k: (v, self.limits[k]) for k, v in out.items()}


def control(g, cfg: dict, mix: dict, seed: int, dev) -> dict:
    """The control's compared numbers: the plain MCL in bfloat16 (values,
    products and sums) in the program's place."""
    p = dict(cfg["settings"]["mcl"])
    labels, it = mcl(g, p, dtype=torch.bfloat16)
    return compare_mcl(g, p, labels, it)
