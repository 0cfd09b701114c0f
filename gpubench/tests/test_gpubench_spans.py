"""The ``program_span`` metrics in CPU rehearsals of each cell with
``--trace 1``: each cell reports its own and no other, they agree with
the program's counts, and a program without spans leaves them out."""

import pytest
import torch

from gpubench.core import manifest
from gpubench.core import spans as bench_spans
from gpubench.core.harness import run_cell
from gpubench.tests._tiny import CELLS, CPU
from gpubench.tests.test_gpubench_harness import MCL_TINY

#: A slab budget and a scale small enough that the A² runs in row slabs
#: on the CPU (at CPU scales the card's 2^27 takes a single pass).
A2_TINY = {"max_flops_cap": 1 << 11}
A2_SCALE = 6


def _span_metrics(cell: str = None) -> set:
    bench = manifest.load_benchmark()
    return {m["name"] for m in bench["per_layer"]
            if m["source"] == "program_span"
            and (cell is None or cell in m["workloads"])}


def _rehearse(cell, monkeypatch, seed=2 ** 31 + 11):
    real = manifest.config

    def config(bench, name):
        cfg = real(bench, name)
        settings = dict(cfg["settings"])
        if "max_flops_cap" in settings:
            settings.update(A2_TINY)
        if "mcl" in settings:
            settings["mcl"] = dict(settings["mcl"], **MCL_TINY)
        return dict(cfg, settings=settings)

    monkeypatch.setattr(manifest, "config", config)
    from combblas_tpu_torch.utils import timers
    timers.reset()
    scale = A2_SCALE if cell.startswith("a2") else 9
    return run_cell(cell, seed, 0.5, True, CPU, 0.0, scale=scale)[0]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_its_span_metrics(cell, monkeypatch):
    line = _rehearse(cell, monkeypatch)
    assert line["correct"] is True
    got = {k for k in line["metrics"] if k in _span_metrics()}
    assert got == _span_metrics(cell)
    if cell.startswith("a2"):
        assert line["metrics"]["a2.attempts"]["value"] == 1.0
    for name in got:
        assert line["metrics"][name]["value"] >= 0


def test_span_counts_agree_with_the_program(monkeypatch):
    """Per operation, ``mcl.iteration`` spans = the iterations returned;
    ``bfs.level`` spans = the sweeps; the expansion and the prune lie
    inside the iterations."""
    seen = {}
    real = bench_spans.window_spans

    def keep(ctx):
        got = real(ctx)
        seen["ctx"], seen["spans"] = ctx, got
        return got

    monkeypatch.setattr(bench_spans, "window_spans", keep)
    line = _rehearse("mcl.ssca17", monkeypatch)
    ctx, (rec, first) = seen["ctx"], seen["spans"]
    win = rec[first:]
    iters = sum(r["iterations"] for r in ctx.ops)
    assert sum(s.name == "mcl.iteration" for s in win) == iters
    assert sum(s.name == "mcl.clustering" for s in win) == len(ctx.ops)
    iter_ms = sum(s.device_ns for s in win
                  if s.name == "mcl.iteration") / 1e6 / len(ctx.ops)
    m = line["metrics"]
    assert 0 < m["mcl.expand_ms"]["value"] + m["mcl.prune_ms"]["value"] \
        <= iter_ms

    line = _rehearse("bfs64.g500", monkeypatch)
    ctx, (rec, first) = seen["ctx"], seen["spans"]
    levels = sum(s.name == "bfs.level" for s in rec[first:])
    assert levels == sum(r["sweeps"] for r in ctx.ops)
    assert line["metrics"]["bfs.sweeps"]["value"] == levels / len(ctx.ops)


def test_only_the_window_is_read(monkeypatch):
    """Spans of a traced call made before the window, in the same process,
    are not read as the window's."""
    from combblas_tpu_torch.gen.rmat import rmat_matrix
    from combblas_tpu_torch.ops.spgemm import spgemm_auto
    from combblas_tpu_torch.utils import timers
    timers.reset()
    a = rmat_matrix(torch.Generator().manual_seed(0), 7, 8, symmetrize=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        spgemm_auto(a, a, nnz_estimate=8)   # retried
    earlier = timers.spans()
    assert sum(s.name == "spgemm.attempt" for s in earlier) > 1
    monkeypatch.setattr(timers, "reset", lambda: None)
    line = _rehearse("a2_keep.ssca20", monkeypatch)
    assert len(timers.spans()) > len(earlier)
    assert line["metrics"]["a2.attempts"]["value"] == 1.0


def test_a_program_without_spans_gives_none(monkeypatch):
    """The parent's program has no ``spans``: the readers return None and
    the line leaves their metrics out."""
    from combblas_tpu_torch.utils import timers
    monkeypatch.delattr(timers, "spans")
    line = _rehearse("spmm128.g500", monkeypatch)
    assert line["correct"] is True
    assert not set(line["metrics"]) & _span_metrics()
