"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.

``LAUNCHES`` counts, per kernel instance, the wrapper calls that launched
the CUDA kernel (never the plain version): a run reads it to show that its
main path went through the kernels.  :func:`poison_allocator` makes a
kernel's unwritten output slots show in a check against the plain version.
"""

import torch

LAUNCHES = {"expand_i32": 0, "expand_i64": 0, "expand_chunks_i32": 0,
            "compress_i32": 0, "compress_i64": 0,
            "ell_sum": 0, "ell_max": 0, "spmm_coo": 0, "ring_shift": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def poison_allocator(nbytes, device) -> None:
    """Hand the caching allocator blocks of these sizes filled with 0xA5
    bytes (no key sentinel, no 0 value), then free them: outputs of these
    sizes allocated next, in this order, with ``torch.empty`` reuse them, so
    a slot that a kernel leaves unwritten cannot match the plain version by
    luck.  The cache is emptied first, so that no other free block is
    handed out instead."""
    torch.cuda.empty_cache()
    blocks = [torch.full((nb,), 0xA5, dtype=torch.uint8, device=device)
              for nb in nbytes]
    del blocks
