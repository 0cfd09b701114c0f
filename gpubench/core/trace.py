"""Reading a ``torch.profiler`` trace of the measured window.

The helpers ``interval_union`` (there ``interval_union_us``),
``STAGES``, ``kernel_base`` and ``stage_of`` are frozen copies of
``combblas_tpu_torch/profile_seg2.py``'s, so that a change to the
program's profilers does not move what is measured.  Times here are
nanoseconds on the profiler's clock.
"""

from __future__ import annotations

import bisect
import dataclasses

import torch

__all__ = ["STAGES", "WINDOW_SPAN", "Trace", "interval_union",
           "kernel_base", "stage_of", "collect"]

#: The harness's span around the measured window.
WINDOW_SPAN = "gpubench.window"

#: Stage of a device event: (stage, kernel base names, name parts).  The
#: port's kernels match by their whole base name, library kernels and
#: copies by a part of their name; anything else is "other".
STAGES = (
    ("expand", ("count_kernel", "split_kernel", "expand_kernel",
                "expand_chunks_kernel"), ()),
    ("compress", ("compress_kernel", "pad_kernel"), ()),
    ("sort", (), ("RadixSort", "radix_sort")),
    ("assembly", (), ("Memcpy DtoD",)),
)


def kernel_base(name: str) -> str:
    """``void (anonymous namespace)::expand_kernel<int>(int const*, ...)``
    -> ``expand_kernel``."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].split("::")[-1].strip()


def stage_of(name: str, stages=STAGES) -> str:
    """The first of ``stages`` that a device event's name matches."""
    base = kernel_base(name)
    for stage, bases, parts in stages:
        if base in bases or any(p in name for p in parts):
            return stage
    return "other"


def interval_union(spans) -> float:
    """Total length covered by (start, end) intervals, overlaps once."""
    return sum(e - s for s, e in _merged(spans))


def _merged(spans) -> list:
    out: list = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@dataclasses.dataclass
class Trace:
    """The device and host events of the measured window, clipped to it.

    ``device``: (name, start, end) of every kernel, copy and set on the
    card; ``host``: (name, start, end) of every host-side event (operators,
    runtime calls, spans)."""

    start: int
    end: int
    device: list
    host: list

    @property
    def window_ns(self) -> int:
        return self.end - self.start

    def busy_ns(self) -> float:
        return interval_union([(s, e) for _n, s, e in self.device])

    def idle_pct(self) -> float | None:
        """100 x (1 - busy / window), or None without device events."""
        if not self.device:
            return None
        return 100.0 * (1.0 - self.busy_ns() / self.window_ns)

    def device_ns(self, match) -> float:
        """Summed device time of the events whose name ``match`` accepts."""
        return float(sum(e - s for n, s, e in self.device if match(n)))

    def by_name(self) -> list:
        """[(name, seconds)] of the device events summed by kernel base
        name, largest first."""
        out: dict = {}
        for n, s, e in self.device:
            k = kernel_base(n) or n
            out[k] = out.get(k, 0) + (e - s)
        return sorted(((k, v / 1e9) for k, v in out.items()),
                      key=lambda kv: -kv[1])

    def idle_gaps(self, top: int = 10) -> list:
        """The ``top`` longest stretches of the window in which the device
        ran nothing, each named by the innermost host event that covered
        its middle: [(name, seconds)]."""
        busy = _merged([(s, e) for _n, s, e in self.device])
        gaps, t = [], self.start
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end > t:
            gaps.append((t, self.end))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        out = []
        for g0, g1 in gaps:
            mid = (g0 + g1) // 2
            name = "host"
            for h in reversed(host[:bisect.bisect_right(starts, mid)]):
                if h[2] >= mid and h[0] != WINDOW_SPAN:
                    name = h[0]
                    break
            out.append((name, (g1 - g0) / 1e9))
        return out


def _raw_events(prof):
    """(name, is_device, start_ns, end_ns, is_span) of every event of a
    finished profile, from the profiler's raw kineto list.  ``is_span``: a
    span (``record_function``), which the profiler also draws on the
    device's timeline, where it is no work of the device."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.device_type() == cuda, e.start_ns(),
             e.start_ns() + e.duration_ns(), e.is_user_annotation())
            for e in prof.profiler.kineto_results.events()]


def collect(prof) -> Trace | None:
    """The :class:`Trace` of the window that the harness's span marks, or
    None if the profile holds no such span."""
    evs = _raw_events(prof)
    win = [(s, e) for n, dev, s, e, _sp in evs
           if n == WINDOW_SPAN and not dev]
    if not win:
        return None
    w0, w1 = win[0]
    device, host = [], []
    for n, dev, s, e, span in evs:
        s, e = max(s, w0), min(e, w1)
        if e <= s or (dev and (span or n == WINDOW_SPAN)):
            continue
        (device if dev else host).append((n, s, e))
    return Trace(start=w0, end=w1, device=device, host=host)
