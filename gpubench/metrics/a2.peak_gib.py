"""a2.peak_gib: the largest max_memory_allocated of one call, in GiB."""


def read(ctx):
    peaks = [r["peak_bytes"] for r in ctx.ops if "peak_bytes" in r]
    return max(peaks) / 2**30 if peaks and max(peaks) > 0 else None
