"""What the metric readers under ``gpubench/metrics/`` share.

A reader is ``read(ctx) -> number | None``; ``ctx`` holds the cell's
``config`` and ``traffic``, ``setup_s``, ``window_s``, ``ops`` (one record
per operation of the window), the driver's ``counts`` and, in a traced
run, ``trace`` (:class:`gpubench.core.trace.Trace`).  A reader that finds
nothing to read returns None, and the metric is left out of the line.
"""

from __future__ import annotations

from gpubench.core.trace import kernel_base, stage_of
from gpubench.count.work import bound_s

__all__ = ["stage_ms_per_op", "roofline_pct", "op_mean",
           "A2_KERNELS", "ELL_KERNELS"]

#: The expansion and compression kernels of ``csrc/expand.cu`` and
#: ``csrc/compress.cu`` (K1-K4), by base name.
A2_KERNELS = ("count_kernel", "split_kernel", "expand_kernel",
              "compress_kernel", "pad_kernel")
#: The ELL fold's kernels (``csrc/ell.cu``: K6, K7).
ELL_KERNELS = ("ell_kernel", "ell_combine_kernel")


def stage_ms_per_op(ctx, stage: str):
    """Device milliseconds a window operation spent in ``stage``."""
    if ctx.trace is None or not ctx.trace.device or not ctx.ops:
        return None
    ns = ctx.trace.device_ns(lambda n: stage_of(n) == stage)
    return ns / 1e6 / len(ctx.ops)


def roofline_pct(ctx, kernels, work) -> float | None:
    """100 x (the bound of the window's work) / (device time of the
    ``kernels``); ``work`` is a list of (bytes, operations), one per
    piece of work the kernels did.  None when they did not run."""
    if ctx.trace is None:
        return None
    ns = ctx.trace.device_ns(lambda n: kernel_base(n) in kernels)
    if ns <= 0:
        return None
    return 100.0 * sum(bound_s(b, f) for b, f in work) / (ns / 1e9)


def op_mean(ctx, key: str):
    vals = [r[key] for r in ctx.ops if key in r]
    return sum(vals) / len(vals) if vals else None
