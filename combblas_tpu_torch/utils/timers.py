"""Program spans and profiling helpers (port of
``combblas_tpu/utils/timers.py``).

The counterpart of the reference's global phase timers
(``cblas_alltoalltime`` / ``cblas_localspmvtime`` / ..., ``CombBLAS.h:76-102``)
and its per-run breakdowns (``3DSpGEMM/Multiplier.h:50-58``), as spans at
the port's layer boundaries.  A span records only while a
``torch.profiler`` profile records; otherwise ``with span(...)`` costs one
check of the profiler's state and does nothing else:

    with torch.profiler.profile():
        mcl_local(a, params)
    print(timers.report())     # count, host, device and self ms by name

While recording, a span (1) enters ``torch.profiler.record_function``, so
the trace names the region on the same clock as the device's kernels,
(2) stamps its host start and end and its parent, and (3) on a CUDA
tensor's device records a timing event on the current stream at entry and
at exit, never waiting for them.  :func:`spans` waits for the device once
and resolves the events.  The record lives in memory, at most :data:`CAP`
spans until :func:`reset`; spans past it are counted (:func:`dropped`).
One thread records at a time.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict

import torch

__all__ = ["CAP", "Span", "span", "spans", "report", "reset", "dropped",
           "device_memory_report"]

#: Most spans the record holds between two :func:`reset` calls.
CAP = 1 << 18

_profiling = torch._C._autograd._profiler_enabled


@dataclasses.dataclass(frozen=True)
class Span:
    """One resolved span.  ``parent`` and ``root`` index the list that
    :func:`spans` returns (``parent`` -1 for a root; a root is its own
    ``root``, the identifier every span of one call shares).  ``device_ns``
    is the time between its two device events, or its host time where it
    had none (CPU work); ``self_ns`` is ``device_ns`` less the part of it
    that its children cover."""

    name: str
    parent: int
    root: int
    host_ns: int
    device_ns: int
    self_ns: int


class _Off:
    """The shared context of a span while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


_record: list = []     # _On of the recorded spans, in the order they began
_stack: list = []      # indices of the open spans (-1: not recorded)
_resolved: list = []   # Span, a prefix of _record
_dropped = 0


class _On:
    """A span while a profiler records: host stamps, and on a CUDA device
    two events.  ``ref``: the outermost enclosing span on the same device,
    whose first event is the origin of this one's device times."""

    __slots__ = ("name", "like", "rf", "parent", "root", "t0", "t1", "dev",
                 "ev0", "ev1", "ref")

    def __init__(self, name: str, like):
        self.name, self.like = name, like
        self.ev0 = self.ev1 = self.t1 = None

    def __enter__(self):
        global _dropped
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        if len(_record) >= CAP:
            _dropped += 1
            _stack.append(-1)
            return None
        idx = len(_record)
        self.parent = _stack[-1] if _stack else -1
        up = _record[self.parent] if self.parent >= 0 else None
        self.root = up.root if up is not None else idx
        like, self.like = self.like, None   # the record keeps no tensor
        self.dev = (like.device if like is not None and like.is_cuda
                    else up.dev if up is not None else None)
        self.ref = up.ref if up is not None and up.dev == self.dev else idx
        _record.append(self)
        _stack.append(idx)
        self.t0 = time.perf_counter_ns()
        if self.dev is not None:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev0.record(torch.cuda.current_stream(self.dev))
        return None

    def __exit__(self, *exc):
        _stack.pop()
        if self.ev1 is not None:
            self.ev1.record(torch.cuda.current_stream(self.dev))
        self.t1 = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        self.rf = None
        return False


def span(name: str, like: torch.Tensor | None = None):
    """A context that names a region of the program.  ``like``: a tensor
    the region works on; on a CUDA device the region is also timed there.
    A span without a CUDA tensor takes its parent's device."""
    if not _profiling():
        return _OFF
    return _On(name, like)


def _covered(lo: int, hi: int, ivs) -> int:
    """Length of [lo, hi) that the intervals ``ivs`` cover."""
    covered, end = 0, lo
    for s, e in sorted(ivs):
        s, e = max(s, end), min(e, hi)
        if e > s:
            covered += e - s
            end = e
    return covered


def _resolve() -> None:
    """Resolve the record past its resolved prefix, up to the call (the
    outermost span) that is still open."""
    start, stop = len(_resolved), len(_record)
    open_roots = [i for i in _stack if i >= 0]
    if open_roots:
        stop = open_roots[0]   # a recorded span with nothing above is a root
    if stop <= start:
        return
    todo = _record[start:stop]
    for d in {e.dev for e in todo if e.dev is not None}:
        torch.cuda.synchronize(d)
    # an entry's interval on its own clock: ns from its ref's first event
    # on a device, the host clock for CPU work
    iv = []
    for i, e in enumerate(todo, start):
        if e.dev is None:
            iv.append((e.t0, e.t1))
            continue
        s = (0 if e.ref == i
             else round(_record[e.ref].ev0.elapsed_time(e.ev0) * 1e6))
        iv.append((s, s + round(e.ev0.elapsed_time(e.ev1) * 1e6)))
    kids = defaultdict(list)
    for i, e in enumerate(todo, start):
        if e.parent >= start:
            kids[e.parent].append(i)
    for i, e in enumerate(todo, start):
        s, t = iv[i - start]
        if e.dev is None:       # children on the host clock
            inner = [(_record[k].t0, _record[k].t1) for k in kids[i]]
        else:                   # children timed from the same origin
            inner = [iv[k - start] for k in kids[i]
                     if _record[k].ref == e.ref]
        _resolved.append(Span(e.name, e.parent, e.root, e.t1 - e.t0, t - s,
                              t - s - _covered(s, t, inner)))
    for e in todo:              # the events are read: let them go
        e.ev0 = e.ev1 = None


def spans() -> list:
    """The record as :class:`Span` s, in the order they began: every
    call whose outermost span has ended.  Waits once for the devices that
    hold unresolved events."""
    _resolve()
    return list(_resolved)


def dropped() -> int:
    """Spans not recorded since the last :func:`reset` (past :data:`CAP`)."""
    return _dropped


def report() -> str:
    """One line a span name: count, host ms, device ms and self ms in
    total, largest device time first."""
    tot = defaultdict(lambda: [0, 0, 0, 0])
    for s in spans():
        t = tot[s.name]
        t[0] += 1
        t[1] += s.host_ns
        t[2] += s.device_ns
        t[3] += s.self_ns
    lines = [f"{'span':24s} {'count':>8s} {'host ms':>12s} "
             f"{'device ms':>12s} {'self ms':>12s}"]
    for name, (n, h, d, sf) in sorted(tot.items(), key=lambda kv: -kv[1][2]):
        lines.append(f"{name:24s} {n:8d} {h / 1e6:12.3f} {d / 1e6:12.3f} "
                     f"{sf / 1e6:12.3f}")
    if _dropped:
        lines.append(f"({_dropped} spans dropped past {CAP})")
    return "\n".join(lines)


def reset() -> None:
    """Empty the record (spans still open stay unrecorded)."""
    global _dropped
    _record.clear()
    _resolved.clear()
    _stack[:] = [-1] * len(_stack)
    _dropped = 0


def device_memory_report() -> str:
    """Memory of every visible card, from ``torch.cuda.memory_stats`` (the
    reference's SHOW_MEMORY_USAGE prints, ``ParFriends.h:643-717``); empty
    without a card."""
    if not torch.cuda.is_available():
        return ""
    lines = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        used = stats.get("allocated_bytes.all.current", 0)
        peak = stats.get("allocated_bytes.all.peak", 0)
        limit = torch.cuda.get_device_properties(i).total_memory
        lines.append(f"cuda:{i}: in_use={used/1e9:.2f}GB "
                     f"peak={peak/1e9:.2f}GB limit={limit/1e9:.2f}GB")
    return "\n".join(lines)
