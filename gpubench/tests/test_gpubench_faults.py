"""The check of each cell fails when the timed path is broken underneath:
a whole run of the harness on the CPU at a tiny scale, with a fault
planted in the program, comes out ``correct: false``.  Each cell gets
the faults it can have: an answer altered where it is produced, half of
the batch left out, and a step that returns its state unchanged (one
card: no exchange to leave out)."""

import dataclasses

import pytest
import torch

import combblas_tpu_torch.models.bfs as prog_bfs
import combblas_tpu_torch.models.mcl as prog_mcl
from gpubench.drivers import a2_keep, bfs_batch, spmm
from gpubench.tests.test_gpubench_harness import _run


def _alter_val(c):
    val = c.val.clone()
    val[0] += 1
    return dataclasses.replace(c, val=val)


def _half_nnz(c):
    return dataclasses.replace(c, nnz=c.nnz // 2)


A2_FAULTS = {
    "answer_altered": lambda real: lambda a, b, **k: _alter_val(
        real(a, b, **k)),
    "half_left_out": lambda real: lambda a, b, **k: _half_nnz(
        real(a, b, **k)),
    "state_unchanged": lambda real: lambda a, b, **k: a,
}


@pytest.mark.parametrize("fault", sorted(A2_FAULTS))
def test_a2_fault(fault, monkeypatch):
    monkeypatch.setattr(a2_keep, "spgemm_auto",
                        A2_FAULTS[fault](a2_keep.spgemm_auto))
    line, _ = _run("a2_keep.ssca20", False, monkeypatch)
    assert line["correct"] is False


def _bfs_altered(real):
    def f(a, roots, **k):
        parents, levels = real(a, roots, **k)
        parents = parents.clone()
        r = int(roots[0])
        parents[0, r] = (r + 1) % parents.shape[1]
        return parents, levels
    return f


def _bfs_half(real):
    def f(a, roots, **k):
        parents, levels = real(a, roots, **k)
        h = parents.shape[0] // 2
        parents, levels = parents.clone(), levels.clone()
        parents[h:], levels[h:] = -1, -1
        return parents, levels
    return f


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out"])
def test_bfs_fault(fault, monkeypatch):
    wrap = {"answer_altered": _bfs_altered, "half_left_out": _bfs_half}
    monkeypatch.setattr(bfs_batch, "bfs_batch_pull_big",
                        wrap[fault](bfs_batch.bfs_batch_pull_big))
    line, _ = _run("bfs64.g500", False, monkeypatch)
    assert line["correct"] is False


def test_bfs_sweep_returns_state_unchanged(monkeypatch):
    monkeypatch.setattr(prog_bfs, "ell_fold",
                        lambda cols, vals, rs, rl, f, **k: torch.zeros_like(f))
    line, comp = _run("bfs64.g500", False, monkeypatch)
    assert line["correct"] is False
    assert comp["level_mismatch"][0] > 0


def _spmm_altered(real):
    def f(a, x, **k):
        y = real(a, x, **k).clone()
        y[0, 0] += 1
        return y
    return f


def _spmm_half(real):
    def f(a, x, **k):
        h = x.shape[1] // 2
        y = real(a, x[:, :h].contiguous(), **k)
        return torch.cat([y, torch.zeros_like(y)], 1)
    return f


SPMM_FAULTS = {"answer_altered": _spmm_altered, "half_left_out": _spmm_half,
               "state_unchanged": lambda real: lambda a, x, **k: x}


@pytest.mark.parametrize("fault", sorted(SPMM_FAULTS))
def test_spmm_fault(fault, monkeypatch):
    monkeypatch.setattr(spmm, "spmm", SPMM_FAULTS[fault](spmm.spmm))
    line, _ = _run("spmm128.g500", False, monkeypatch)
    assert line["correct"] is False


def _mcl_altered(real):
    def f(a, params=None, **k):
        labels, it = real(a, params, **k)
        labels = labels.clone()
        _, inv, cnt = torch.unique(labels, return_inverse=True,
                                   return_counts=True)
        v = int(torch.nonzero(cnt[inv] > 1)[0])   # a vertex not alone
        labels[v] = labels.shape[0] + 1            # moved to a new cluster
        return labels, it
    return f


def test_mcl_answer_altered(monkeypatch):
    from gpubench.drivers import mcl
    monkeypatch.setattr(mcl, "mcl_local", _mcl_altered(mcl.mcl_local))
    line, comp = _run("mcl.ssca17", False, monkeypatch)
    assert line["correct"] is False and comp["labels_moved"][0] > 0


def test_mcl_half_of_the_expansion_left_out(monkeypatch):
    real = prog_mcl.spgemm_auto
    monkeypatch.setattr(prog_mcl, "spgemm_auto",
                        lambda a, b, **k: _half_nnz(real(a, b, **k)))
    line, _ = _run("mcl.ssca17", False, monkeypatch)
    assert line["correct"] is False


def test_mcl_iteration_returns_state_unchanged(monkeypatch):
    monkeypatch.setattr(prog_mcl, "_mcl_iteration",
                        lambda a, p, cap, plan: (a, float(prog_mcl.chaos(a))))
    line, comp = _run("mcl.ssca17", False, monkeypatch)
    assert line["correct"] is False and comp["iter_gap"][0] > 0
