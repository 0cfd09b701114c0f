"""Edge cases for the tiled expansion (K1/K3, and the chunk-padded K5) and
compress (K2/K4) kernels, as numpy arrays from a seed.
``tests/test_torch_expand.py``, ``tests/test_torch_spgemm.py`` (K5) and
``tests/test_torch_compress.py`` feed them to the port's plain versions and
to the JAX kernels (interpret mode); ``tests/test_torch_kernels_cuda.py``
feeds them to the CUDA kernels and the plain versions on the card.

``tile`` is the kernels' tile in slots or elements (``EXPAND_TILE`` /
``COMPRESS_TILE``; for K5 ``CH`` against JAX, so that the hub row crosses
chunk edges, and ``EXPAND_CHUNKS_TILE * CH`` on the card): the cases put B
rows, dead entries and runs across and onto its edges.  Values are
multiples of 1/4 in [0.25, 1], so every run's sum is exact in float32
whatever the order of the fold (the kernels, the plain versions and the JAX
kernel each fold in their own order)."""

import numpy as np

SENT32 = np.iinfo(np.int32).max
SENT64 = np.iinfo(np.int64).max


def quarters(rng, size):
    return (rng.integers(1, 5, size) / 4).astype(np.float32)


def _csr(rng, lens, n):
    rp = np.zeros(len(lens) + 1, np.int64)
    rp[1:] = np.cumsum(lens)
    col = rng.integers(0, n, int(rp[-1])).astype(np.int32)
    return rp, col, quarters(rng, int(rp[-1]))


# --------------------------------------------------------------- expansion --

EXPAND_CASES = ("hub_row", "dead_and_empty", "no_products")


def expand_case(name: str, tile: int, seed: int = 0) -> dict:
    """A's entries (row sorted, col, val, valid) and B's CSR (row pointer,
    col, val) over ``n`` columns, with ``m`` rows of A.

    - ``hub_row``: B row 5 holds 5 tiles and 37 entries; three A entries
      take it, one of them first;
    - ``dead_and_empty``: 10^4 consecutive dead A entries, then 3000 live
      entries on B rows of 0, between live entries on rows of 0..16;
    - ``no_products``: every A entry dead, so the stream is all pad."""
    rng = np.random.default_rng(seed)
    k, n, m = 64, 12000, 40
    lens = rng.integers(0, 17, k)
    lens[[3, 9, 10]] = 0
    if name == "hub_row":
        lens[5] = 5 * tile + 37
    b_rp, b_col, b_val = _csr(rng, lens, n)
    if name == "hub_row":
        na = 300
        a_col = rng.integers(0, k, na)
        a_col[[0, 150, 299]] = 5
        valid = np.ones(na, bool)
    elif name == "dead_and_empty":
        na = 300 + 10_000 + 3000 + 300
        a_col = rng.integers(0, k, na)
        a_col[10_300:13_300] = rng.choice([3, 9, 10], 3000)
        valid = np.ones(na, bool)
        valid[300:10_300] = False
    elif name == "no_products":
        na = 500
        a_col = rng.integers(0, k, na)
        valid = np.zeros(na, bool)
    else:
        raise ValueError(name)
    a_row = np.sort(rng.integers(0, m, na)).astype(np.int32)
    return dict(a_row=a_row, a_col=a_col.astype(np.int32),
                a_val=quarters(rng, na), a_valid=valid, b_rp=b_rp,
                b_col=b_col, b_val=b_val, m=m, n=n)


def expand_total(case: dict) -> int:
    rp, acol = case["b_rp"], case["a_col"]
    return int(np.where(case["a_valid"], rp[acol + 1] - rp[acol], 0).sum())


def expand_caps(case: dict) -> list:
    """Stream capacities: one that cuts inside the first hub entry's (or the
    longest entry's) products, one tile's worth past the total, and 1."""
    rp, acol = case["b_rp"], case["a_col"]
    cnt = np.where(case["a_valid"], rp[acol + 1] - rp[acol], 0)
    total = int(cnt.sum())
    caps = [total + 1 + 2048, 1]
    if total:
        e = int(np.argmax(cnt))
        caps.append(int(cnt[:e].sum()) + int(cnt[e]) // 2 + 1)
    return caps


def expand_chunk_caps(case: dict, cpb: int = 16) -> list:
    """K5 chunk capacities, multiples of ``cpb`` (the JAX kernel's chunks a
    grid step): one past the last live chunk (dummy chunks follow), the
    smallest, and one that cuts inside the first entry of several chunks
    that crosses a multiple of ``cpb``, as near its middle as one lies (a
    hub entry; without one, halfway through the live chunks)."""
    rp, acol = case["b_rp"], case["a_col"]
    nch = -(-np.where(case["a_valid"], rp[acol + 1] - rp[acol], 0) // 128)
    end = np.cumsum(nch)
    start = end - nch
    chunks = int(end[-1])
    caps = [(chunks // cpb + 2) * cpb, cpb]
    for s0, e0 in zip(start[nch > 1], end[nch > 1]):
        c = max(int(s0 + e0) // 2 // cpb, int(s0) // cpb + 1) * cpb
        if c < e0:
            caps.append(c)
            break
    else:
        if chunks // 2 >= cpb:
            caps.append(chunks // 2 // cpb * cpb)
    return caps


# ---------------------------------------------------------------- compress --

COMPRESS_CASES = ("run_lengths", "one_run", "single", "single_sentinel",
                  "all_sentinel")


def compress_case(name: str, tile: int, seed: int = 0):
    """A key stream (int64, sentinel SENT64) sorted within each stretch
    between sentinels, and its values.

    - ``run_lengths``: runs of 1, T-1, T, T+1 and 5T (T = ``tile``) and
      short ones, with sentinel runs between some, so runs start, end and
      cross at the tile edges; n is not a multiple of T;
    - ``one_run``: one key over the whole stream of 3T + 7;
    - ``single`` / ``single_sentinel``: n = 1;
    - ``all_sentinel``: 2T + 3 sentinels."""
    rng = np.random.default_rng(seed)
    t = tile
    if name == "run_lengths":
        pattern = [1, t - 1, t, t + 1, 5 * t, 1, 1, 3, t - 1, 2, t, t + 1]
        keys, key = [], 10
        for i, ln in enumerate(pattern):
            keys.append(np.full(ln, key, np.int64))
            key += int(rng.integers(1, 1000))
            if i % 3 == 2:  # sentinels between runs; the keys go on rising
                keys.append(np.full(int(rng.integers(1, 40)), SENT64))
        keys.append(np.full(5, SENT64))
        keys = np.concatenate(keys)
    elif name == "one_run":
        keys = np.full(3 * t + 7, 77, np.int64)
    elif name == "single":
        keys = np.array([5], np.int64)
    elif name == "single_sentinel":
        keys = np.array([SENT64], np.int64)
    elif name == "all_sentinel":
        keys = np.full(2 * t + 3, SENT64)
    else:
        raise ValueError(name)
    return keys, quarters(rng, keys.shape[0])


def as_int32(keys):
    """The same stream with int32 keys (sentinel SENT32)."""
    return np.where(keys == SENT64, SENT32, keys).astype(np.int32)


def compress_nnz(keys) -> int:
    head = np.r_[True, keys[1:] != keys[:-1]]
    return int((head & (keys != keys.dtype.type(np.iinfo(keys.dtype).max)))
               .sum())


def compress_caps(nnz: int) -> list:
    """Output capacities: room for all, exactly nnz, and one that cuts."""
    caps = [nnz + 2048, max(nnz, 1)]
    if nnz > 1:
        caps.append(nnz // 2)
    return caps


# -- the row-window sort (K10 keyed by row) ------------------------------

#: Row lengths of the keyed-by-row cases: rows in every width range of the
#: narrow instances (2-512, 513-4096, 4097-16384) and past them, on both
#: sides of each limit, empty rows and rows of one product; rows whose few
#: columns repeat (stability inside a window and across wide tiles); wide
#: rows of whole and partial 16384-slot tiles.
ROW_SORT_CASES = {
    "ranges": [0, 1, 2, 511, 512, 513, 4096, 4097, 16384, 16385, 40000, 0,
               3],
    "equal_cols": [600, 5000, 0, 20000, 70000, 1],
    "tile_edges": [32768, 32769, 49152, 7, 16383],
}


def row_sort_case(name: str, key64: bool, key_bits: int, seed: int = 0,
                  tail: int = 1000) -> dict:
    """A compacted expansion stream of ``ROW_SORT_CASES[name]``'s rows:
    keys ``row * stride + col`` (stride n + 1, columns below n, n needing
    ``key_bits`` bits; three columns only in ``equal_cols``), each row's
    products together, rows ascending, then ``tail`` sentinel slots;
    values distinct (0 on the tail), so a run of equal keys shows its
    order.  ``rows`` rows, and ``rowfl`` / ``row_start`` as
    ``_row_flops_exact`` gives them, a pad row last."""
    rng = np.random.default_rng(seed)
    lens = np.array(ROW_SORT_CASES[name] + [0], np.int64)
    n = (1 << key_bits) - 3
    hi = 3 if name == "equal_cols" else n
    row = np.repeat(np.arange(lens.size, dtype=np.int64), lens)
    col = rng.integers(0, hi, row.size)
    kdt = np.int64 if key64 else np.int32
    sent = SENT64 if key64 else SENT32
    key = np.concatenate([row * (n + 1) + col,
                          np.full(tail, sent, np.int64)]).astype(kdt)
    val = np.concatenate([np.arange(row.size) + 0.5,
                          np.zeros(tail)]).astype(np.float32)
    return dict(key=key, val=val, rows=lens.size - 1, rowfl=lens,
                row_start=np.cumsum(lens) - lens, stride=n + 1, n=n,
                key_bits=key_bits)
