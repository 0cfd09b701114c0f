"""Labelled-graph I/O: string vertex names mapped to dense ids (port of
``combblas_tpu/io/labels.py``).

The counterpart of ``SpParMat::ReadGeneralizedTuples`` (used by
``CC.cpp:144`` for protein-name graphs).  Labels are interned on the host
in first-appearance order; the matrix then goes to the device.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from combblas_tpu_torch.io.mtx import _live_host
from combblas_tpu_torch.ops.coo import SpCOO

__all__ = ["read_labeled_tuples", "write_labeled_tuples"]


def read_labeled_tuples(path: str, weighted: bool = True, device=None
                        ) -> Tuple[SpCOO, List[str]]:
    """Read whitespace-separated ``src dst [weight]`` lines with any string
    vertex names; returns (matrix on ``device``, labels), ``labels[i]`` the
    name of vertex i (ids in first-appearance order, the reference's
    permutation-free mode).  Lines starting with ``%`` or ``#`` are
    comments."""
    ids: Dict[str, int] = {}
    rows: List[int] = []
    cols: List[int] = []
    vals: List[float] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2 or parts[0].startswith(("%", "#")):
                continue
            rows.append(ids.setdefault(parts[0], len(ids)))
            cols.append(ids.setdefault(parts[1], len(ids)))
            vals.append(float(parts[2]) if weighted and len(parts) > 2
                        else 1.0)
    n = len(ids)
    mat = SpCOO.from_arrays(np.asarray(rows), np.asarray(cols),
                            np.asarray(vals, np.float32), (n, n),
                            device=device)
    return mat, list(ids)


def write_labeled_tuples(path: str, a: SpCOO, labels: List[str]) -> None:
    r, c, v = _live_host(a)
    with open(path, "w") as f:
        for i, j, w in zip(r, c, v):
            f.write(f"{labels[i]}\t{labels[j]}\t{w:.9g}\n")
