"""2-D blocked degree-sorted ELL-8 SpMM: y = A (.) X (port of
``combblas_tpu/ops/pallas/spmm_ell_blocked.py``).

The plan is the JAX package's, array for array: rows are ranked by
descending degree and relabeled block-interleaved (sorted rank r -> row
block r % nb, local slot r // nb), packed 8 per group, and every group's
entries in column block cb form one run of positions, ELL-padded to the
group's longest row in that block.  Runs of the nb x nb (row block, column
block) segments sit at ``seg_off + inner prefix``, each segment padded to
``t_seg`` tiles of 1024 positions, as the TPU grid wanted; the port keeps
that layout so plans compare bit for bit.

The plan is built on the operand's device with stable sorts, bincounts,
cumsums and index scatters: no host numpy pass over the entries.  Besides
the JAX arrays it holds the run table the CUDA kernel walks (``run_start``,
``run_len``: (G, nb) int32, per group and column block), which the TPU
kernel recovered from ``flush`` instead.

The fold (sum, or max from 0) is ``ops/kernels/ell.py``: the kernel walks
the plan's piece table (``pieces``, built once here): each group's runs cut
into pieces of at most ``piece_len_for`` the plan's positions, so a hub
group is folded by many warps, its partial tiles combined in a second pass.
"""

from __future__ import annotations

import torch

from combblas_tpu_torch.ops.coo import SpCOO
from combblas_tpu_torch.ops.kernels.ell import ell_fold, ell_pieces
from combblas_tpu_torch.utils.timers import span

__all__ = ["ell_blocked_prepare", "spmm_ell_blocked"]

#: Positions per TPU grid tile; the plan pads each segment to a multiple of
#: it so that it equals the JAX plan bit for bit.
_TP = 1024


def _excl_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.cumsum(x, dim) - x


def ell_blocked_prepare(a: SpCOO, nb: int = 6, *, relabel_cols: bool = False,
                        binary: bool = False) -> dict:
    """Blocked ELL-8 plan of ``a`` on its device.

    ``relabel_cols`` also renames columns by the block-interleaved degree
    order (square operands only): X and Y then live in the relabeled space
    and no per-call unpermute is needed (the BFS sweep's mode).  ``binary``
    replaces values with 1.0.  Returns the JAX plan's arrays ``cols``,
    ``vals`` ((8, P) views of (P, 8) storage), ``flush``, ``base``,
    ``order``, ``inv``, ``live`` and statics ``P``, ``t_seg``, ``nb``,
    ``bs_r``, ``bs_c``, ``m_pad``, ``n_pad``, ``relabel_cols``, plus the
    run table ``run_start`` / ``run_len`` and the kernel's piece table
    ``pieces`` (:func:`ell_pieces` of it)."""
    m, n = a.shape
    if relabel_cols and m != n:
        raise ValueError(f"relabel_cols needs a square operand, got {a.shape}")
    with span("ell.prepare", a.row):
        dev = a.device
        nnz = int(a.nnz)
        i64 = dict(dtype=torch.int64, device=dev)
        row = a.row[:nnz].long()
        col = a.col[:nnz].long()
        val = (torch.ones(nnz, dtype=torch.float32, device=dev) if binary
               else a.val[:nnz].float())
        deg = torch.bincount(row, minlength=m)
        srt = torch.sort(-deg, stable=True)[1]
        rank0 = torch.empty(m, **i64)
        rank0[srt] = torch.arange(m, **i64)

        bs_r = -(-m // (8 * nb)) * 8          # row-block size (multiple of 8)
        m_pad = bs_r * nb
        g_rb = bs_r // 8                      # groups per row block
        rank = (rank0 % nb) * bs_r + rank0 // nb
        order = torch.full((m_pad,), -1, **i64)   # relabeled id -> original id
        order[rank] = torch.arange(m, **i64)
        bs_c = bs_r if relabel_cols else -(-n // (8 * nb)) * 8
        n_pad = bs_c * nb

        e_r = rank[row]
        e_c = rank[col] if relabel_cols else col
        cb_e = e_c // bs_c
        key = e_r * nb + cb_e
        ldeg = torch.bincount(key, minlength=m_pad * nb)
        groups = m_pad // 8
        lgc = ldeg.reshape(groups, 8, nb).amax(1)              # (G, nb)
        # segment (rb, cb): groups rb*g_rb .. (rb+1)*g_rb-1 at column block cb
        lens = lgc.reshape(nb, g_rb, nb).transpose(1, 2).reshape(-1)
        lens2 = lens.reshape(nb * nb, g_rb)
        t_seg = max(-(-int(lens2.sum(1).max()) // _TP), 1)
        seg_cap = t_seg * _TP
        p_pad = seg_cap * nb * nb
        if p_pad >= 1 << 31:
            raise ValueError(f"{p_pad} ELL positions exceed int32")
        seg_off = torch.arange(nb * nb, **i64) * seg_cap
        g_start = (seg_off[:, None] + _excl_cumsum(lens2, 1)).reshape(-1)

        # entries sorted by (relabeled row, column block), stable: within-row
        # order is kept; each entry's step within its run is its rank in its
        # key
        sort_idx = torch.sort(key, stable=True)[1]
        key_s = key[sort_idx]
        within = torch.arange(nnz, **i64) - _excl_cumsum(ldeg)[key_s]
        er_s = e_r[sort_idx]
        cb_s = cb_e[sort_idx]
        g_s = er_s >> 3
        seg_idx = (g_s // g_rb) * (nb * g_rb) + cb_s * g_rb + g_s % g_rb
        dest_p = g_start[seg_idx] + within
        dest_i = er_s & 7
        cols_pt = torch.zeros((p_pad, 8), dtype=torch.int32, device=dev)
        vals_pt = torch.zeros((p_pad, 8), dtype=torch.float32, device=dev)
        cols_pt[dest_p, dest_i] = (e_c[sort_idx] - cb_s * bs_c).to(torch.int32)
        vals_pt[dest_p, dest_i] = val[sort_idx]
        # flush at the last position of every (group, column block) run; runs
        # with no entries drop into the spare slot at p_pad
        live_seg = lens > 0
        last_pos = torch.where(live_seg, g_start + lens - 1, p_pad)
        g_local = torch.arange(nb * nb * g_rb, **i64) % g_rb
        flush = torch.zeros(p_pad + 1, dtype=torch.int32, device=dev)
        flush[last_pos] = 1
        base = torch.zeros(p_pad + 1, dtype=torch.int32, device=dev)
        base[last_pos] = (g_local * 8).to(torch.int32)

        # the run table, group-major: (rb, cb, g_local) -> (rb, g_local, cb)
        def by_group(t):
            return (t.reshape(nb, nb, g_rb).transpose(1, 2)
                    .reshape(groups, nb).to(torch.int32).contiguous())

        run_start, run_len = by_group(g_start), by_group(lens)
        return dict(
            cols=cols_pt.t(), vals=vals_pt.t(),
            flush=flush[:p_pad], base=base[:p_pad],
            order=order.to(torch.int32), inv=rank.to(torch.int32),
            live=deg > 0,
            run_start=run_start, run_len=run_len,
            pieces=ell_pieces(run_start, run_len),
            P=p_pad, t_seg=t_seg, nb=nb, bs_r=bs_r, bs_c=bs_c,
            m_pad=m_pad, n_pad=n_pad, relabel_cols=relabel_cols,
        )


def spmm_ell_blocked(a: SpCOO, x: torch.Tensor, prep: dict | None = None, *,
                     nb: int = 6, op: str = "sum") -> torch.Tensor:
    """y = A @ X through the blocked ELL-8 fold (``op="sum"``), or the
    max from 0 over the products (``op="max"``, the BFS pull).  Any width
    d; X is not padded to 128 lanes.  The output is unpermuted to the
    original row order, except for ``relabel_cols`` plans, whose X and Y
    stay in the relabeled space.  Pass ``prep``
    (:func:`ell_blocked_prepare`) to amortize planning."""
    if prep is None:
        prep = ell_blocked_prepare(a, nb)
    xp = x.float()
    short = prep["n_pad"] - xp.shape[0]
    if prep["relabel_cols"] and short > 0:     # X lives in relabeled space
        xp = torch.cat([xp, xp.new_zeros((short, xp.shape[1]))])
    with span("spmm.fold", xp):
        y_perm = ell_fold(prep["cols"].t(), prep["vals"].t(),
                          prep["run_start"], prep["run_len"], xp.contiguous(),
                          bs_c=prep["bs_c"], op=op, pieces=prep["pieces"])
    if prep["relabel_cols"]:
        return y_perm.to(x.dtype)
    with span("spmm.unpermute", y_perm):
        y = torch.where(prep["live"][:, None], y_perm[prep["inv"].long()],
                        0.0)
        return y.to(x.dtype)
