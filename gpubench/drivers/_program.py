"""The drivers' graphs, and the program's view of them.

A traffic mix either takes the graph scrambled by the run's seed, or,
with ``labellings: [j, ...]``, cycles through those fixed labellings of
it (the same for every run), in an order drawn from the seed: each run
then does the same work, in another order.  The drivers hand the program
a ``SpCOO`` made from the benchmark's own arrays: the live entries, then
``(n, n, 0)`` sentinels up to a capacity of the power of two at or above
the generator's edge slots, as the port's own generator sizes it.
"""

from __future__ import annotations

import numpy as np
import torch

from combblas_tpu_torch.ops.coo import SpCOO
from gpubench.gen.rmat import labelling_seed, make_graph

__all__ = ["graphs", "program_starts", "to_spcoo"]


def program_starts(dev) -> None:
    """Mark the end of the benchmark's own set-up (graphs, counts): the
    run's ``memory_peak_bytes`` counts from here, so it is the program's
    set-up and window and not the generator's sorts."""
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def graphs(cfg: dict, mix: dict, seed: int, dev) -> list:
    """The graphs a run's operations take in turn (operation i takes
    ``[i % len]``)."""
    spec = cfg["graph"]
    if "labellings" not in mix:
        return [make_graph(spec, seed, dev)]
    ids = mix["labellings"]
    order = np.random.default_rng(seed).permutation(len(ids))
    return [make_graph(spec, labelling_seed(spec["graph_seed"], ids[k]), dev)
            for k in order]


def to_spcoo(g) -> SpCOO:
    n, nnz = g.n, g.nnz
    cap = max(8, 1 << max(g.slots - 1, 1).bit_length())
    pad = cap - nnz
    dev = g.row.device
    fill = torch.full((pad,), n, dtype=torch.int32, device=dev)
    return SpCOO(row=torch.cat([g.row, fill]), col=torch.cat([g.col, fill]),
                 val=torch.cat([g.val, torch.zeros(pad, dtype=g.val.dtype,
                                                   device=dev)]),
                 nnz=torch.tensor(nnz, dtype=torch.int64, device=dev),
                 shape=(n, n))
