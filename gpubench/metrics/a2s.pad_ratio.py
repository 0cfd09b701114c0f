"""a2s.pad_ratio: elements the streamed A²'s window sorts take a call
(the held plan's padded size a slab times its slabs) over the products it
forms; each operation's record carries both, read from the plan."""


def read(ctx):
    recs = [r for r in ctx.ops if "padded" in r]
    if not recs:
        return None
    return sum(r["padded"] * r["slabs"] / r["products"]
               for r in recs) / len(recs)
