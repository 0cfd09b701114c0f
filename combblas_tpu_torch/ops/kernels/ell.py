"""Degree-sorted ELL-8 fold: the CUDA kernel ``csrc/ell.cu`` and its plain
version.

One kernel for two TPU kernels: :func:`ell_fold` with ``op="sum"`` replaces
``combblas_tpu/ops/pallas/spmm_ell.py:_spmm_ell_call`` (K6; the ELL-8 plan
is the blocked plan with one block) and, with ``op="sum"`` or ``"max"``,
``combblas_tpu/ops/pallas/spmm_ell_blocked.py:_ell_blocked_call`` (K7).

The plan holds, per position p, 8 entries ``(cols[p, i], vals[p, i])``, one
per row ``g*8 + i`` of the group that owns p, and per group g and column
block cb one run of positions ``run_start[g, cb] .. + run_len[g, cb]``.
Row ``g*8 + i`` of the output folds ``vals[p, i] * X[cb*bs_c + cols[p, i]]``
over the positions of all of g's runs, starting from 0: a sum, or a max
from 0 (the TPU kernel zeroes its output and accumulator).  ELL padding
slots (col 0, val 0) take part, as on the TPU.

The kernel walks a piece table (:func:`ell_pieces`): each group's runs, laid
end to end in column-block order, cut into pieces of at most ``piece_len``
positions, so that a hub group is folded by many warps at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from combblas_tpu_torch.ops.kernels import LAUNCHES, _build

__all__ = ["EllPieces", "PIECE_LEN", "ell_fold", "ell_fold_plain",
           "ell_pieces", "piece_len_for"]

_OPS = {"sum": 0, "max": 1}
#: Positions per chunk of the plain version: bounds its (chunk, 8, d)
#: product tensor (256 MB at d = 128).
_PLAIN_CHUNK = 1 << 16
#: The pieces the card folds at once at d = 128: 132 SMs x 24 resident
#: warps / 2 warps a piece.  The default L shares a plan's positions among
#: them: a longer piece outlasts the rest of pass 1, a shorter one only
#: adds partial tiles to pass 2.
_RESIDENT_PIECES = 132 * 24 // 2
#: The default L's bounds: under 64 positions pass 2's tiles cost more
#: than pass 1 gains; 1024 (about 4 MB of X gathers at d = 128) is the
#: longest piece measured.
_MIN_PIECE_LEN = 64
PIECE_LEN = 1024


class EllPieces(NamedTuple):
    """The kernel's work list, built on the run table's device.

    ``table`` (n, 4) int32, one row per piece, longest first: ``run`` =
    g*nb + cb of its first position, ``start`` (that position), ``len``
    (positions, walking on into g's later runs), ``out`` (-1: g is one
    piece and the kernel writes its rows of Y; else the partial tile it
    writes).  ``folds`` (f, 3) int32: every group with other than one
    piece, its first tile and its tile count (0: its rows are 0); a
    group's tiles are consecutive, in piece order.  ``run_start`` and
    ``run_len`` are the run table it was cut from: :func:`ell_fold` takes
    it with those tensors only."""
    table: torch.Tensor
    folds: torch.Tensor
    tiles: int
    piece_len: int
    run_start: torch.Tensor
    run_len: torch.Tensor


def piece_len_for(positions: int) -> int:
    """The default piece length of a plan of ``positions`` positions: its
    share of the pieces the card folds at once, from 64 to
    ``PIECE_LEN``."""
    return min(PIECE_LEN, max(_MIN_PIECE_LEN, positions // _RESIDENT_PIECES))


def ell_pieces(run_start, run_len, piece_len: int | None = None
               ) -> EllPieces:
    """Cut each group's runs, in column-block order, into pieces of at most
    ``piece_len`` positions (default :func:`piece_len_for` the plan's
    positions); a group with no positions has no piece."""
    groups, nb = run_len.shape
    dev = run_len.device
    lens = run_len.long()
    glen = lens.sum(1)
    if piece_len is None:
        piece_len = piece_len_for(int(glen.sum()))
    if piece_len < 1:
        raise ValueError(f"piece_len must be >= 1, got {piece_len}")
    npc = (glen + piece_len - 1) // piece_len             # pieces per group
    total = int(npc.sum())
    grp = torch.repeat_interleave(torch.arange(groups, device=dev), npc,
                                  output_size=total)
    k = torch.arange(total, device=dev) - (torch.cumsum(npc, 0) - npc)[grp]
    off = k * piece_len                  # into the group's runs end to end
    length = torch.clamp(glen[grp] - off, max=piece_len)
    ends = torch.cumsum(lens, 1)[grp]                    # (total, nb)
    cb = (ends <= off[:, None]).sum(1)   # the first run that ends past off
    before = ends.gather(1, cb[:, None])[:, 0] - lens[grp, cb]
    start = run_start.long()[grp, cb] + off - before
    tiles = torch.where(npc > 1, npc, 0)
    first = torch.cumsum(tiles, 0) - tiles
    out = torch.where(npc[grp] > 1, first[grp] + k, -1)
    table = torch.stack([grp * nb + cb, start, length, out], 1)
    table = table[torch.sort(-length, stable=True)[1]]   # longest first
    fg = torch.nonzero(npc != 1)[:, 0]
    folds = torch.stack([fg, first[fg], tiles[fg]], 1)
    return EllPieces(table.to(torch.int32).contiguous(),
                     folds.to(torch.int32).contiguous(), int(tiles.sum()),
                     piece_len, run_start, run_len)


def ell_fold_plain(cols, vals, run_start, run_len, x, *, bs_c: int,
                   op: str) -> torch.Tensor:
    """Plain PyTorch fold: every run's positions are listed with
    ``repeat_interleave``, their rows of X gathered and scaled, and folded
    into Y with ``index_add_`` (sum, of the float32 products in float64,
    as the kernel adds) or ``scatter_reduce_`` (``amax`` with the
    zero-filled Y included)."""
    groups, nb = run_start.shape
    d = x.shape[1]
    dev = x.device
    y = torch.zeros((groups * 8, d), device=dev,
                    dtype=torch.float64 if op == "sum" else torch.float32)
    lens = run_len.reshape(-1).long()
    total = int(lens.sum())
    run = torch.repeat_interleave(torch.arange(groups * nb, device=dev), lens,
                                  output_size=total)
    pos = (torch.arange(total, device=dev) - (torch.cumsum(lens, 0)
                                              - lens)[run]
           + run_start.reshape(-1).long()[run])
    eight = torch.arange(8, device=dev)
    for lo in range(0, total, _PLAIN_CHUNK):
        hi = min(lo + _PLAIN_CHUNK, total)
        p, r = pos[lo:hi], run[lo:hi]
        src = cols[p].long() + (r % nb * bs_c)[:, None]         # (k, 8)
        prod = (vals[p][..., None] * x[src]).reshape(-1, d)      # (k*8, d)
        dst = ((r // nb)[:, None] * 8 + eight).reshape(-1)
        if op == "sum":
            y.index_add_(0, dst, prod.double())
        else:
            y.scatter_reduce_(0, dst[:, None].expand(-1, d), prod,
                              reduce="amax", include_self=True)
    return y.float()


def _check(name, t, dtype, dim, dev):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dim}-D tensor")


def ell_fold(cols, vals, run_start, run_len, x, *, bs_c: int,
             op: str = "sum", plain: bool = False,
             pieces: EllPieces | None = None) -> torch.Tensor:
    """Y (G*8, d) float32 from the ELL-8 plan and X (rows, d) float32.

    ``cols`` int32 and ``vals`` float32 are (P, 8), ``run_start`` and
    ``run_len`` int32 (G, nb), all contiguous on X's device.  CPU tensors,
    or ``plain=True``, take :func:`ell_fold_plain`; CUDA tensors launch
    ``csrc/ell.cu`` on ``pieces``, :func:`ell_pieces` of these very
    ``run_start`` / ``run_len`` tensors (built here when not given: pass
    the plan's to keep its host syncs out of the call).  The caller keeps
    every column ``cb*bs_c + col`` of a run inside X."""
    if op not in _OPS:
        raise ValueError(f"op must be 'sum' or 'max', got {op!r}")
    dev = x.device
    for name, t, dt, dim in (("cols", cols, torch.int32, 2),
                             ("vals", vals, torch.float32, 2),
                             ("run_start", run_start, torch.int32, 2),
                             ("run_len", run_len, torch.int32, 2),
                             ("x", x, torch.float32, 2)):
        _check(name, t, dt, dim, dev)
    if cols.shape != vals.shape or cols.shape[1] != 8:
        raise ValueError(f"cols/vals must be (P, 8), got {tuple(cols.shape)} "
                         f"and {tuple(vals.shape)}")
    if run_start.shape != run_len.shape:
        raise ValueError("run_start and run_len differ in shape")
    if pieces is not None and (pieces.run_start is not run_start
                               or pieces.run_len is not run_len):
        raise ValueError("pieces were cut from another run table")
    if dev.type == "cpu" or plain:
        return ell_fold_plain(cols, vals, run_start, run_len, x, bs_c=bs_c,
                              op=op)
    if dev.type != "cuda":
        raise ValueError(f"no ELL kernel for device {dev}")
    if pieces is None:
        pieces = ell_pieces(run_start, run_len)
    _check("pieces.table", pieces.table, torch.int32, 2, dev)
    _check("pieces.folds", pieces.folds, torch.int32, 2, dev)
    if (pieces.table.shape[1] != 4 or pieces.folds.shape[1] != 3
            or pieces.table.data_ptr() % 16):
        raise ValueError("pieces must hold a 16-byte aligned (n, 4) table "
                         "and (f, 3) folds")
    groups, nb = run_start.shape
    d = x.shape[1]
    y = torch.empty((groups * 8, d), dtype=torch.float32, device=dev)
    part = torch.empty((pieces.tiles, 8, d), device=dev,
                       dtype=torch.float64 if op == "sum" else torch.float32)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cbt_ell_fold(cols.data_ptr(), vals.data_ptr(),
                               run_start.data_ptr(), run_len.data_ptr(),
                               pieces.table.data_ptr(),
                               pieces.table.shape[0],
                               pieces.folds.data_ptr(),
                               pieces.folds.shape[0], nb, bs_c,
                               x.data_ptr(), d, _OPS[op], part.data_ptr(),
                               y.data_ptr(), stream)
    _build.check(lib, err, f"ell_{op}")
    LAUNCHES[f"ell_{op}"] += 1
    return y
