"""Graph500's search in batches: ``bfs_batch_pull_big`` from ``roots``
fresh roots of degree >= 1 a batch, drawn from the seed, through the
blocked ELL plan (``nb`` column blocks) built in set-up.  Each root's
Graph500 edge count (the edges of its component) is counted in set-up
from the graph; the last batch's parents and levels are held against
plain searches."""

from __future__ import annotations

import numpy as np
import torch

from combblas_tpu_torch.models.bfs import bfs_batch_pull_big
from combblas_tpu_torch.ops.spmm_ell_blocked import ell_blocked_prepare
from gpubench.count.work import component_edges
from gpubench.drivers._program import graphs, program_starts, to_spcoo
from gpubench.ref.bfs import bfs, compare_bfs


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, dev):
        self.g = g = graphs(cfg, mix, seed, dev)[0]
        self.nroots = int(mix["roots"])
        self.limits = mix["limits"]
        lab, edges = component_edges(g.row_ptr, g.row, g.col)
        self.root_edges = edges[lab].cpu().numpy()   # per vertex
        self.cand = torch.nonzero(g.deg > 0).reshape(-1).cpu().numpy()
        self.rng = np.random.default_rng(seed)
        self.counts = {"nnz": g.nnz, "n": g.n, "roots": self.nroots}
        program_starts(dev)
        self.a = to_spcoo(g)
        self.prep = ell_blocked_prepare(self.a, int(mix["nb"]),
                                        relabel_cols=True, binary=True)
        self.last = None

    def _roots(self) -> np.ndarray:
        return self.rng.choice(self.cand, size=self.nroots, replace=False)

    def warm(self) -> None:
        roots = self._roots()
        self.last = (roots, *bfs_batch_pull_big(self.a, roots,
                                                prep=self.prep))

    def op(self, i: int, trace: bool) -> dict:
        roots = self._roots()
        self.last = None
        self.last = (roots, *bfs_batch_pull_big(self.a, roots,
                                                prep=self.prep))
        rec = {"edges": int(self.root_edges[roots].sum())}
        if trace:
            rec["sweeps"] = int(self.last[2].max()) + 1
        return rec

    def release(self) -> None:
        self.a = self.prep = None

    def compare(self) -> dict:
        g = self.g
        roots, parents, levels = self.last
        out = compare_bfs(g, roots, parents, levels)
        return {k: (v, self.limits[k]) for k, v in out.items()}


def control(g, cfg: dict, mix: dict, seed: int, dev) -> dict:
    """The control's compared numbers: plain searches from ``roots`` roots
    drawn from the seed, their parent ids carried in bfloat16, in the
    program's place."""
    cand = torch.nonzero(g.deg > 0).reshape(-1).cpu().numpy()
    roots = np.random.default_rng(seed).choice(cand, size=int(mix["roots"]),
                                               replace=False)
    lv, par = zip(*(bfs(g.row_ptr, g.col, int(r), parent_dtype=torch.bfloat16)
                    for r in roots))
    return compare_bfs(g, roots, torch.stack(par), torch.stack(lv))
