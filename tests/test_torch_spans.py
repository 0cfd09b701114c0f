"""The port's spans (``utils/timers.py``) on the CPU.

With no profiler recording, a span records nothing and enters no
``record_function``.  Under ``torch.profiler`` the spans of small calls
match the program's own counts (slabs of the plan, attempts of the retry
loop, MCL's iterations, BFS's levels, the grid products' local products),
name every stage of each path, nest as the layers do, appear among the
profiler's events, and leave every output as it was, bit for bit.  On
the CPU a span's device time is its host time.  The card test
checks the device events of a span on CUDA tensors.
"""

import time

import numpy as np
import pytest
import torch

from combblas_tpu_torch.gen.rmat import rmat_matrix
from combblas_tpu_torch.models.bfs import bfs_batch_pull_big
from combblas_tpu_torch.models.mcl import MCLParams, mcl_local
from combblas_tpu_torch.ops import spgemm as tsg
from combblas_tpu_torch.ops import spgemm_seg as tseg
from combblas_tpu_torch.ops.coo import SpCOO
from combblas_tpu_torch.ops.spmv import spmm
from combblas_tpu_torch.parallel import memefficient, summa
from combblas_tpu_torch.parallel.dist import DistSpMat
from combblas_tpu_torch.parallel.grid import ProcGrid
from combblas_tpu_torch.utils import timers

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def empty_record():
    timers.reset()
    yield
    timers.reset()


def _graph(scale: int, seed: int = 3):
    gen = torch.Generator().manual_seed(seed)
    return rmat_matrix(gen, scale, edgefactor=8, symmetrize=True,
                       remove_self_loops=True)


def _traced(fn):
    """(fn's output, the spans it recorded, the profiler's event names)."""
    with torch.profiler.profile(activities=CPU) as prof:
        out = fn()
    return out, timers.spans(), {e.name for e in prof.events()}


def _count(sp, name: str) -> int:
    return sum(s.name == name for s in sp)


def _children(sp, i: int) -> list:
    return [s.name for s in sp if s.parent == i]


def _a2(a, nnz_estimate=None):
    return tsg.spgemm_auto(a, a, max_flops_cap=1 << 11,
                           nnz_estimate=nnz_estimate, plan={})


def _bfs(a):
    deg = torch.bincount(a.row[:int(a.nnz)].long(), minlength=a.shape[0])
    roots = torch.nonzero(deg > 0).reshape(-1)[:5].numpy()
    return bfs_batch_pull_big(a, roots)


def _spmm(a):
    x = torch.rand((a.shape[1], 4), generator=torch.Generator().manual_seed(1))
    return spmm(a, x, use_kernel=True)


def _mcl(a):
    return mcl_local(a, MCLParams(select=32, recover_num=32))


def _seg(a):
    return tseg.spgemm_streamed_seg(a, a, num_slabs=5)


def _seg2(a):
    return tseg.spgemm_streamed_seg2(a, a)


def _summa(side: int, staged: bool = False):
    """A² on a side x side block grid: ``summa_spgemm_auto``, or
    ``summa_spgemm_staged`` sized as ``chip_smoke.py`` phase 13 sizes it;
    float32 values, so the local products take the kernel routes."""
    def run(a):
        d = DistSpMat.from_local(a, ProcGrid.make(side, side, device="cpu"))
        if not staged:
            return summa.summa_spgemm_auto(d, d)
        fc, oc = summa.summa_bounds(d, d)
        return memefficient.summa_spgemm_staged(
            d, d, stage_flops_cap=fc, out_capacity=oc,
            impl=summa.summa_impl_auto(d, d),
            chunk_cap=summa.summa_chunk_bound(d, d, fc))
    return run


CALLS = {"spgemm_auto": (_a2, 7), "mcl_local": (_mcl, 7),
         "bfs_batch_pull_big": (_bfs, 8), "spmm": (_spmm, 8),
         "spgemm_streamed_seg": (_seg, 8),
         "spgemm_streamed_seg2": (_seg2, 8),
         "summa_spgemm_auto_2x2": (_summa(2), 7),
         "summa_spgemm_auto_4x4": (_summa(4), 7),
         "summa_spgemm_staged_4x4": (_summa(4, staged=True), 7)}


def _flat(out) -> list:
    """The tensors of a call's output, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    if hasattr(out, "row"):
        return [out.row, out.col, out.val, out.nnz]
    return [torch.as_tensor(out)]


@pytest.mark.parametrize("call", sorted(CALLS))
def test_off_records_nothing(call, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    fn, scale = CALLS[call]
    fn(_graph(scale))
    assert timers.spans() == [] and timers.dropped() == 0
    assert timers.span("x") is timers.span("y")   # the one shared no-op


@pytest.mark.parametrize("call", sorted(CALLS))
def test_outputs_equal_bit_for_bit(call):
    fn, scale = CALLS[call]
    a = _graph(scale)
    off = _flat(fn(a))
    on, sp, names = _traced(lambda: fn(a))
    on = _flat(on)
    assert sp and {s.name for s in sp} <= names
    assert len(on) == len(off)
    for x, y in zip(on, off):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for s in sp:   # self within total; the CPU's device clock is the host's
        assert 0 <= s.self_ns <= s.device_ns == s.host_ns
        assert sp[s.root].parent == -1 and sp[s.root].root == s.root


@pytest.mark.parametrize("nnz_estimate", [None, 8])
def test_spgemm_auto_slabs_and_attempts(nnz_estimate, monkeypatch):
    a = _graph(7)
    routes = []
    real = tsg.spgemm_pallas_rowchunked

    def route(*args, **kwargs):
        routes.append(kwargs["out_capacity"])
        return real(*args, **kwargs)

    monkeypatch.setattr(tsg, "spgemm_pallas_rowchunked", route)
    plan = {}
    with torch.profiler.profile(activities=CPU):
        c = tsg.spgemm_auto(a, a, max_flops_cap=1 << 11,
                            nnz_estimate=nnz_estimate, plan=plan)
    sp = timers.spans()
    assert plan["kind"] == "pallas_slabs"
    slabs = len(tsg._pallas_slab_plan(a, a, plan["num_slabs"],
                                      wide=plan["wide"])[0]) - 1
    assert slabs > 1
    attempts = len(routes)
    assert (attempts > 1) == (nnz_estimate is not None)
    assert int(c.nnz) < routes[-1]
    assert _count(sp, "spgemm.call") == 1
    assert _count(sp, "spgemm.attempt") == attempts
    # the dispatcher's plan, and the slab plan of every attempt
    assert _count(sp, "spgemm.plan") == 1 + attempts
    assert _count(sp, "spgemm.slab") == slabs * attempts
    for i, s in enumerate(sp):
        assert s.root == 0
        if s.name == "spgemm.slab":
            assert sp[s.parent].name == "spgemm.attempt"
            assert _children(sp, i) == [
                "spgemm.extract", "spgemm.expand", "spgemm.sort",
                "spgemm.compress", "spgemm.assemble"]
    assert _children(sp, 0) == ["spgemm.plan"] + ["spgemm.attempt"] * attempts


@pytest.mark.parametrize("held", [True, False])
def test_streamed_seg_slabs(held):
    """One ``seg.call`` a call; ``seg.slab`` and each of its steps once a
    slab of the plan; a call that builds its plan does so inside
    ``seg.call``, in ``spgemm.plan`` spans (the slab plan, the classes)."""
    a = _graph(8)
    prep = tseg.seg_prepare(a, a, 5)
    slabs = len(prep[0]["bounds"]) - 1
    assert slabs == 5
    kw = {"prep": prep} if held else {"num_slabs": 5}
    out, sp, _ = _traced(lambda: tseg.spgemm_streamed_seg(a, a, **kw))
    assert out == tseg.spgemm_streamed_seg(a, a, prep=prep)
    steps = ["seg.extract", "seg.expand", "seg.windows", "seg.sort",
             "seg.compress", "seg.fold"]
    assert _count(sp, "seg.call") == 1 and sp[0].name == "seg.call"
    for name in ["seg.slab"] + steps:
        assert _count(sp, name) == slabs, name
    assert _children(sp, 0) == ([] if held else ["spgemm.plan"] * 2) + \
        ["seg.slab"] * slabs
    for i, s in enumerate(sp):
        if s.name == "seg.slab":
            assert _children(sp, i) == steps


def _esc(sp, prefix: str, n: int) -> None:
    """The ESC stages under ``prefix``: expand, sort and compress, each
    recorded ``n`` times."""
    for stage in ("expand", "sort", "compress"):
        assert _count(sp, f"{prefix}.{stage}") == n, stage


@pytest.mark.parametrize("path", [
    "spgemm_streamed_seg2", "spgemm_auto", "spmm", "bfs_batch_pull_big",
    "summa_spgemm_auto_2x2", "summa_spgemm_auto_4x4",
    "summa_spgemm_staged_4x4"])
def test_stages_of_each_path(path, monkeypatch):
    """Every stage of a path is a span: each slab's or local product's
    expansion, sort and compress; seg2's window gather; the BFS level and
    its fold; the SpMM fold and its unpermute."""
    products = []   # the grid routes' local products
    for mod in (summa, memefficient):
        def counted(*args, real=mod._local_multiply, **kwargs):
            products.append(kwargs["impl"])
            return real(*args, **kwargs)

        monkeypatch.setattr(mod, "_local_multiply", counted)
    fn, scale = CALLS[path]
    a = _graph(scale)
    out, sp, _ = _traced(lambda: fn(a))
    if path == "spgemm_streamed_seg2":
        slabs = tseg.seg2_prepare(a, a)[1]["slabs"]
        windowed = sum(not s["flat"] for s in slabs)
        assert 0 < windowed < len(slabs)
        _esc(sp, "seg2", windowed)
        assert _count(sp, "seg2.windows") == windowed
        _esc(sp, "spgemm", len(slabs) - windowed)
    elif path == "spgemm_auto":
        slabs = _count(sp, "spgemm.slab")
        assert slabs > 1
        _esc(sp, "spgemm", slabs)
    elif path == "spmm":
        assert _count(sp, "spmm.fold") == _count(sp, "spmm.unpermute") == 1
    elif path == "bfs_batch_pull_big":
        depth = int(out[1].max()) + 1
        assert _count(sp, "bfs.level") == _count(sp, "bfs.fold") == depth
    else:
        side = 2 if path.endswith("2x2") else 4
        stages = side if "staged" in path else 1
        assert products and set(products) <= {"pallas", "wide"}
        assert len(products) % (side * side * stages) == 0
        _esc(sp, "spgemm", len(products))


def _dense_ones(n: int) -> SpCOO:
    d = np.ones((n, n), np.float32)
    return SpCOO.from_dense(torch.from_numpy(d), device="cpu")


@pytest.mark.parametrize("case", ["mixed", "flat", "windowed"])
def test_seg2_spans(case):
    """One ``seg2.slab`` a windowed slab of the plan and one
    ``spgemm.slab`` a flat one, in the plan's order, each with its steps:
    a scale-8 graph has both kinds, a scale-6 one only flat slabs, a
    dense 40 x 40 block (1,600 products a row) only windowed ones."""
    a = {"mixed": lambda: _graph(8), "flat": lambda: _graph(6),
         "windowed": lambda: _dense_ones(40)}[case]()
    slabs = tseg.seg2_prepare(a, a)[1]["slabs"]
    kinds = ["spgemm.slab" if s["flat"] else "seg2.slab" for s in slabs]
    assert {"mixed": {"spgemm.slab", "seg2.slab"}, "flat": {"spgemm.slab"},
            "windowed": {"seg2.slab"}}[case] == set(kinds)
    out, sp, _ = _traced(lambda: _seg2(a))
    assert out == _seg2(a)
    assert [s.name for s in sp if s.parent == -1] == kinds
    for i, s in enumerate(sp):
        if s.name == "seg2.slab":
            assert _children(sp, i) == [
                "seg2.extract", "seg2.expand", "seg2.windows", "seg2.sort",
                "seg2.compress", "seg2.fold"]
        if s.name == "spgemm.slab":
            assert _children(sp, i) == [
                "spgemm.extract", "spgemm.expand", "spgemm.sort",
                "spgemm.compress"]


def test_mcl_iterations():
    a = _graph(7)
    (labels, it), sp, _ = _traced(lambda: _mcl(a))
    assert it > 1 and labels.shape == (a.shape[0],)
    assert _count(sp, "mcl.clustering") == _count(sp, "mcl.labels") == 1
    for name in ("mcl.iteration", "mcl.expand", "mcl.prune", "mcl.inflate",
                 "mcl.chaos", "spgemm.call"):
        assert _count(sp, name) == it, name
    for i, s in enumerate(sp):
        if s.name == "mcl.iteration":
            assert _children(sp, i) == ["mcl.expand", "mcl.prune",
                                        "mcl.inflate", "mcl.chaos"]
        if s.name == "spgemm.call":
            assert sp[s.parent].name == "mcl.expand"
    iters = sum(s.device_ns for s in sp if s.name == "mcl.iteration")
    parts = sum(s.device_ns for s in sp
                if s.name in ("mcl.expand", "mcl.prune"))
    assert parts <= iters <= sp[0].device_ns


def test_bfs_levels():
    a = _graph(8)
    (parents, levels), sp, _ = _traced(lambda: _bfs(a))
    depth = int(levels.max()) + 1
    assert depth > 2
    assert _count(sp, "bfs.level") == _count(sp, "bfs.fold") == depth
    assert [s.name for s in sp if s.parent == 0] == (
        ["ell.prepare"] + ["bfs.level"] * depth + ["bfs.unpermute"])
    for i, s in enumerate(sp):
        if s.name == "bfs.level":
            assert _children(sp, i) == ["bfs.fold"]
            assert s.self_ns == s.device_ns - sp[i + 1].device_ns


def test_spmm_fold_and_unpermute():
    _y, sp, _ = _traced(lambda: _spmm(_graph(8)))
    assert [s.name for s in sp] == ["spmm.call", "ell.prepare", "spmm.fold",
                                    "spmm.unpermute"]
    assert all(s.parent == 0 for s in sp[1:])


def test_self_time_is_what_children_leave():
    with torch.profiler.profile(activities=CPU):
        with timers.span("outer"):
            time.sleep(0.002)
            for _ in range(2):
                with timers.span("inner"):
                    time.sleep(0.002)
    sp = timers.spans()
    outer, inner = sp[0], sp[1:]
    assert [s.name for s in inner] == ["inner", "inner"]
    assert outer.self_ns == outer.device_ns - sum(s.device_ns for s in inner)
    assert outer.self_ns >= 2_000_000 and all(
        s.self_ns == s.device_ns >= 2_000_000 for s in inner)
    rep = timers.report().splitlines()
    assert rep[1].split()[:2] == ["outer", "1"]
    assert rep[2].split()[:2] == ["inner", "2"]


def test_open_call_waits_and_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(timers, "CAP", 3)
    with torch.profiler.profile(activities=CPU):
        with timers.span("first"):
            pass
        with timers.span("open"):
            assert [s.name for s in timers.spans()] == ["first"]
            for _ in range(3):
                with timers.span("past the cap"):
                    pass
    assert [s.name for s in timers.spans()] == ["first", "open",
                                                "past the cap"]
    assert timers.dropped() == 2
    assert "2 spans dropped" in timers.report()
    timers.reset()
    assert timers.spans() == [] and timers.dropped() == 0


def test_device_memory_report():
    rep = timers.device_memory_report()
    if not torch.cuda.is_available():
        assert rep == ""
    else:
        assert rep.count("cuda:") == torch.cuda.device_count()


@pytest.mark.gpu
def test_spans_time_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.rand((2048, 2048), device="cuda")
    acts = CPU + [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        with timers.span("outer", x):
            y = x @ x
            with timers.span("inner"):
                for _ in range(4):
                    y = y @ x
    outer, inner = timers.spans()
    assert inner.parent == 0 and outer.root == inner.root == 0
    assert 0 < inner.device_ns < outer.device_ns
    assert abs(outer.self_ns - (outer.device_ns - inner.device_ns)) <= 1000
    assert inner.self_ns == inner.device_ns and outer.host_ns > 0


@pytest.mark.gpu
def test_seg_spans_on_the_card():
    """On the card (K1/K2 launched): one ``seg.slab`` and one of each step
    a slab of the held plan, each timed on the device, and the digest the
    same bit for bit with tracing on and off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(3)
    a = rmat_matrix(gen, 14, edgefactor=8, symmetrize=True,
                    remove_self_loops=True)
    prep = tseg.seg_prepare(a, a, 6)
    slabs = len(prep[0]["bounds"]) - 1
    off = tseg.spgemm_streamed_seg(a, a, prep=prep)
    acts = CPU + [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        on = tseg.spgemm_streamed_seg(a, a, prep=prep)
    sp = timers.spans()
    assert on == off
    assert _count(sp, "seg.call") == 1
    for name in ("seg.slab", "seg.extract", "seg.expand", "seg.windows",
                 "seg.sort", "seg.compress", "seg.fold"):
        assert _count(sp, name) == slabs, name
    assert all(s.device_ns > 0 for s in sp if s.name == "seg.sort")
