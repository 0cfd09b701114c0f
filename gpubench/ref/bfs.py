"""Plain breadth-first search from one root, and the Graph500-style check
of a batch of searches against it.

Plain PyTorch only.  A search expands each level's frontier through the
CSR arrays; a vertex's level is its distance from the root, which every
correct search shares, so levels compare exactly.  Parents are not unique:
a parent is right when it is a neighbour one level up.
"""

from __future__ import annotations

import torch

__all__ = ["bfs", "compare_bfs"]


def bfs(row_ptr: torch.Tensor, col: torch.Tensor, root: int,
        parent_dtype=None) -> tuple:
    """(levels, parents) int64[n] of a search from ``root`` (-1 where not
    reached).  A vertex's parent is its largest-id neighbour one level up.
    With ``parent_dtype`` the parent ids are carried in that float type."""
    n = row_ptr.shape[0] - 1
    dev = col.device
    levels = torch.full((n,), -1, dtype=torch.int64, device=dev)
    parents = torch.full((n,), -1, dtype=torch.int64, device=dev)
    levels[root], parents[root] = 0, root
    front = torch.tensor([root], dtype=torch.int64, device=dev)
    depth = 0
    while front.numel():
        cnt = row_ptr[front + 1] - row_ptr[front]
        total = int(cnt.sum())
        if total == 0:
            break
        src = torch.repeat_interleave(front, cnt, output_size=total)
        start = torch.repeat_interleave(row_ptr[front] - (torch.cumsum(cnt, 0)
                                                          - cnt), cnt,
                                        output_size=total)
        dst = col[start + torch.arange(total, device=dev)].long()
        new = levels[dst] < 0
        src, dst = src[new], dst[new]
        depth += 1
        levels[dst] = depth
        cand = torch.full((n,), -1, dtype=torch.int64, device=dev)
        cand.scatter_reduce_(0, dst, src, "amax")
        front = torch.unique(dst)
        parents[front] = cand[front]
    if parent_dtype is not None:
        parents = torch.where(parents >= 0,
                              parents.to(parent_dtype).to(torch.int64), -1)
    return levels, parents


def compare_bfs(g, roots, parents: torch.Tensor, levels: torch.Tensor
                ) -> dict:
    """Hold a batch of searches, (R, n) parents and levels in original
    vertex ids, against plain searches of ``g`` from ``roots``.

    Returns ``level_mismatch``: (root, vertex) pairs whose level differs
    from the reference's; ``bad_parent``: pairs whose parent is wrong (the
    root not its own parent, a reached vertex whose parent is no
    neighbour one level up, an unreached one with a parent)."""
    n = g.n
    keys = g.row.long() * n + g.col.long()          # sorted
    mismatch = bad = 0
    for i, root in enumerate(int(r) for r in roots):
        ref, _ = bfs(g.row_ptr, g.col, root)
        lv = levels[i].long()
        par = parents[i].long()
        mismatch += int((lv != ref).sum())
        bad += int(par[root] != root)
        bad += int((par[ref < 0] != -1).sum())
        vis = torch.nonzero(ref > 0).reshape(-1)
        p = par[vis]
        ok = (p >= 0) & (p < n)
        pc = p.clamp(0, n - 1)
        want = pc * n + vis
        at = torch.searchsorted(keys, want).clamp(max=keys.shape[0] - 1)
        ok &= (keys[at] == want) & (ref[pc] == ref[vis] - 1)
        bad += int((~ok).sum())
    return {"level_mismatch": mismatch, "bad_parent": bad}
