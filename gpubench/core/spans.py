"""The program's spans (``combblas_tpu_torch/utils/timers.py``) of the
traced window, for the readers of ``program_span`` metrics.

The program records spans only while a ``torch.profiler`` profile
records, which in a run is the measured window.  The record is the
process's, so the window's spans are its last ones: as many as the
trace holds host events of the spans' names, and with the same names in
the same order; where they differ nothing is read.  A program without
spans (one older than them) gives None too, and the metric is left out.
"""

from __future__ import annotations

__all__ = ["window_spans", "count", "ms_per_op"]


def window_spans(ctx):
    """(the program's spans, index of the window's first) or None."""
    if ctx.trace is None or not ctx.ops:
        return None
    try:
        from combblas_tpu_torch.utils.timers import spans
    except ImportError:
        return None
    rec = spans()
    names = {s.name for s in rec}
    seen = [h[0] for h in sorted(ctx.trace.host, key=lambda h: (h[1], -h[2]))
            if h[0] in names]
    first = len(rec) - len(seen)
    if not seen or first < 0 or [s.name for s in rec[first:]] != seen:
        return None
    return rec, first


def count(ctx, name: str) -> int | None:
    """How many spans named ``name`` the window holds (None: no record)."""
    got = window_spans(ctx)
    if got is None:
        return None
    rec, first = got
    return sum(s.name == name for s in rec[first:])


def ms_per_op(ctx, name: str, field: str = "device_ns") -> float | None:
    """Milliseconds of ``field`` (``host_ns``, ``device_ns`` or
    ``self_ns``) an operation of the window spent in spans named ``name``,
    a span inside another of the name counted in it; None where none ran."""
    got = window_spans(ctx)
    if got is None:
        return None
    rec, first = got
    total, seen = 0, False
    for s in rec[first:]:
        if s.name != name:
            continue
        seen = True
        p = s.parent
        while p >= 0 and rec[p].name != name:
            p = rec[p].parent
        if p < 0:
            total += getattr(s, field)
    return total / 1e6 / len(ctx.ops) if seen else None
