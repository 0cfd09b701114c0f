"""The port's ``ops/ewise.py`` vs the JAX package's on shared numpy inputs:
whole arrays, pads included.  Keys and nnz exact; values exact (no sum is
folded in these functions)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from combblas_tpu.ops import ewise as jew  # noqa: E402
from combblas_tpu.ops.coo import SpCOO as JCOO  # noqa: E402
from combblas_tpu_torch.ops import ewise as tew  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402


def _port(a):
    return TCOO.from_numpy(np.asarray(a.row), np.asarray(a.col),
                           np.asarray(a.val), int(a.nnz), a.shape,
                           device="cpu")


def _same(t, j):
    """Port SpCOO ``t`` equals JAX SpCOO ``j`` slot for slot."""
    assert t.shape == tuple(j.shape)
    assert t.capacity == j.capacity
    assert int(t.nnz) == int(j.nnz)
    np.testing.assert_array_equal(t.row.numpy(), np.asarray(j.row))
    np.testing.assert_array_equal(t.col.numpy(), np.asarray(j.col))
    np.testing.assert_array_equal(t.val.numpy(), np.asarray(j.val))


def _matrix(seed, m=23, n=31, e=120, cap_extra=13):
    """A random (m, n) matrix with empty rows/columns, mixed-sign values
    and pads."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, m - 2, e)
    c = rng.integers(0, n, e)
    c[c == 4] = 5
    v = (rng.random(e) - 0.4).astype(np.float32)
    a = JCOO.from_arrays(r, c, v, (m, n))
    nnz = int(a.nnz)
    return JCOO.from_arrays(np.asarray(a.row)[:nnz],
                            np.asarray(a.col)[:nnz],
                            np.asarray(a.val)[:nnz], (m, n),
                            capacity=nnz + cap_extra)


def _pair(seed):
    """Two matrices of one shape that share about half their keys."""
    ja = _matrix(seed)
    rng = np.random.default_rng(seed + 100)
    nnz = int(ja.nnz)
    take = rng.random(nnz) < 0.5
    r = np.concatenate([np.asarray(ja.row)[:nnz][take],
                        rng.integers(0, 23, 40)])
    c = np.concatenate([np.asarray(ja.col)[:nnz][take],
                        rng.integers(0, 31, 40)])
    v = (rng.random(r.size) + 0.1).astype(np.float32)
    jb = JCOO.from_arrays(r, c, v, ja.shape, capacity=128)
    return ja, jb


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_values(seed):
    ja = _matrix(seed)
    _same(tew.apply_values(_port(ja), lambda v: v * 3 - 1),
          jew.apply_values(ja, lambda v: v * 3 - 1))


@pytest.mark.parametrize("out_cap", [None, 200, 20])
@pytest.mark.parametrize("seed", [0, 1])
def test_prune(seed, out_cap):
    """``out_cap`` 20 is below the kept count: nnz counts every kept
    entry, the buffer holds the first 20."""
    ja = _matrix(seed)
    _same(tew.prune(_port(ja), lambda v: v < 0, out_capacity=out_cap),
          jew.prune(ja, lambda v: v < 0, out_capacity=out_cap))


@pytest.mark.parametrize("out_cap", [None, 30])
def test_prune_i(out_cap):
    ja = _matrix(2)

    def pred(r, c, v):
        return (r + c) % 3 == 0

    _same(tew.prune_i(_port(ja), pred, out_capacity=out_cap),
          jew.prune_i(ja, pred, out_capacity=out_cap))


@pytest.mark.parametrize("dim", ["row", "col"])
@pytest.mark.parametrize("fn", ["mul", "add"])
def test_dim_apply(dim, fn):
    ja = _matrix(3)
    m, n = ja.shape
    x = (np.random.default_rng(4).random(m if dim == "row" else n)
         + 0.5).astype(np.float32)
    tfn, jfn = ((torch.mul, jnp.multiply) if fn == "mul"
                else (torch.add, jnp.add))
    _same(tew.dim_apply(_port(ja), torch.from_numpy(x), dim, tfn),
          jew.dim_apply(ja, jnp.asarray(x), dim, jfn))


@pytest.mark.parametrize("out_cap", [None, 25])
def test_prune_column(out_cap):
    ja = _matrix(5)
    x = (np.random.default_rng(6).random(ja.shape[1]) - 0.2).astype(
        np.float32)
    _same(tew.prune_column(_port(ja), torch.from_numpy(x),
                           lambda v, g: v < g, out_capacity=out_cap),
          jew.prune_column(ja, jnp.asarray(x), lambda v, g: v < g,
                           out_capacity=out_cap))


@pytest.mark.parametrize("out_cap", [None, 10])
def test_compact(out_cap):
    ja = _matrix(7)
    keep = np.random.default_rng(8).random(ja.capacity) < 0.6
    _same(tew._compact(_port(ja), torch.from_numpy(keep), out_cap),
          jew._compact(ja, jnp.asarray(keep), out_cap))


def _tsub(x, y):
    return x - y * 2


def _jsub(x, y):
    return x - y * 2


@pytest.mark.parametrize("mode", ["union", "intersect", "a_minus_b"])
@pytest.mark.parametrize("present", [(False, False), (True, False),
                                     (False, True)])
@pytest.mark.parametrize("out_cap", [None, 16])
def test_ewise_apply(mode, present, out_cap):
    ja, jb = _pair(9)
    kw = dict(a_default=0.5, b_default=-3.0, mode=mode,
              out_capacity=out_cap, a_present_only=present[0],
              b_present_only=present[1])
    _same(tew.ewise_apply(_port(ja), _port(jb), _tsub, **kw),
          jew.ewise_apply(ja, jb, _jsub, **kw))


@pytest.mark.parametrize("seed", [10, 11])
def test_ewise_apply_disjoint_and_equal(seed):
    """No shared key, and every key shared."""
    ja, _ = _pair(seed)
    jb = _matrix(seed + 50, e=60)
    for a, b in ((ja, jb), (ja, ja)):
        for mode in ("union", "intersect", "a_minus_b"):
            _same(tew.ewise_apply(_port(a), _port(b), _tsub, mode=mode),
                  jew.ewise_apply(a, b, _jsub, mode=mode))


@pytest.mark.parametrize("exclude", [False, True])
def test_ewise_mult(exclude):
    ja, jb = _pair(12)
    _same(tew.ewise_mult(_port(ja), _port(jb), exclude=exclude),
          jew.ewise_mult(ja, jb, exclude=exclude))


def test_set_difference_and_add():
    ja, jb = _pair(13)
    _same(tew.set_difference(_port(ja), _port(jb), out_capacity=64),
          jew.set_difference(ja, jb, out_capacity=64))
    _same(tew.add(_port(ja), _port(jb)), jew.add(ja, jb))
