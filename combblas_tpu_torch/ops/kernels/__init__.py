"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.

``LAUNCHES`` counts, per kernel instance, the wrapper calls that launched
the CUDA kernel (never the plain version): a run reads it to show that its
main path went through the kernels.
"""

LAUNCHES = {"expand_i32": 0, "expand_i64": 0, "expand_chunks_i32": 0,
            "compress_i32": 0, "compress_i64": 0,
            "ell_sum": 0, "ell_max": 0, "spmm_coo": 0, "ring_shift": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
