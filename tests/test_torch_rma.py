"""The port's ring SUMMA and its one-hop ring push (K9's plain version on
the CPU) vs the JAX package's.

JAX's ``summa_spgemm_rma(interpret=True)`` moves its blocks with
``lax.ppermute`` (the Pallas interpreter emulates remote DMAs only on
one-axis meshes), so the whole ring path is held against that run, and the
ring push itself against ``_ring_shift_kernel`` on a one-axis 8-device
mesh, as ``tests/test_rma.py`` drives it.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from combblas_tpu import semiring as jsr  # noqa: E402
from combblas_tpu.parallel import rma as jrma  # noqa: E402
from combblas_tpu.parallel import summa as jsu  # noqa: E402
from combblas_tpu_torch import semiring as tsr  # noqa: E402
from combblas_tpu_torch.ops.kernels.ring import ring_shift  # noqa: E402
from combblas_tpu_torch.parallel import rma as trma  # noqa: E402
from combblas_tpu_torch.parallel import summa as tsu  # noqa: E402
from combblas_tpu_torch.parallel.grid import ProcGrid  # noqa: E402
from tests.test_coo import rand_sparse  # noqa: E402
from tests.test_torch_dist import (  # noqa: E402
    assert_same_blocks,
    dist_pair,
)


@pytest.mark.parametrize("sr_name,shapes,seed", [
    ("plus_times", ((30, 26), (26, 34)), 60),
    ("min_plus", ((24, 24), (24, 24)), 62),
    ("max_times", ((24, 24), (24, 24)), 64),
])
def test_rma_summa_matches_jax(sr_name, shapes, seed):
    ja, ta = dist_pair(rand_sparse(*shapes[0], 0.2, seed=seed))
    jb, tb = dist_pair(rand_sparse(*shapes[1], 0.2, seed=seed + 1))
    fc, oc = jsu.summa_bounds(ja, jb)
    jc = jrma.summa_spgemm_rma(ja, jb, jsr.get_semiring(sr_name),
                               stage_flops_cap=fc, out_capacity=oc,
                               interpret=True)
    tc = trma.summa_spgemm_rma(ta, tb, tsr.get_semiring(sr_name),
                               stage_flops_cap=fc, out_capacity=oc)
    assert_same_blocks(tc, jc, exact=sr_name != "plus_times")
    # and the all-gather SUMMA's product
    ts = tsu.summa_spgemm(ta, tb, tsr.get_semiring(sr_name), flops_cap=fc,
                          out_capacity=oc)
    np.testing.assert_allclose(tc.to_dense(), ts.to_dense(), rtol=1e-5)


def test_rma_summa_one_block():
    """On a 1x1 grid the ring has one stage and nothing moves."""
    d = rand_sparse(12, 12, 0.3, seed=66)
    ja, ta = dist_pair(d, 1, 1)
    fc, oc = jsu.summa_bounds(ja, ja)
    jc = jrma.summa_spgemm_rma(ja, ja, stage_flops_cap=fc, out_capacity=oc,
                               interpret=True)
    tc = trma.summa_spgemm_rma(ta, ta, stage_flops_cap=fc, out_capacity=oc)
    assert_same_blocks(tc, jc)
    np.testing.assert_allclose(tc.to_dense(), d @ d, rtol=1e-5, atol=1e-6)


def test_ring_shift_matches_jax_ring_shift_kernel():
    """K9's semantics against the Pallas RDMA push itself: device d of an
    8-device ring receives the (8, 128) buffer of device d-1; the port's
    (1, 8) block grid along 'c' does the same."""
    mesh = jax.make_mesh((8,), ("x",))
    shift = jrma._ring_shift_kernel(8, jnp.float32, "x", collective_id=3)

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=P("x"),
                       out_specs=P("x"), check_vma=False)
    def step(x):
        return shift(x, interpret=True)

    x = np.arange(64 * 128, dtype=np.float32).reshape(64, 128)
    want = np.asarray(step(jnp.asarray(x)))
    got = ring_shift([torch.from_numpy(x).reshape(1, 8, 8, 128)], ["c"])[0]
    np.testing.assert_array_equal(got.reshape(64, 128).numpy(), want)


@pytest.mark.parametrize("axis,dim", [("c", 1), ("r", 0)])
@pytest.mark.parametrize("grid", [(1, 1), (1, 8), (3, 2), (4, 4)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.int64])
@pytest.mark.parametrize("payload", [(13,), (4096,), ()])
def test_ring_shift_plain_is_a_roll(axis, dim, grid, dtype, payload):
    """The plain push, ragged lengths, both axes, 4- and 8-byte types, a
    1x1 grid: block (i, j) lands one hop on along the axis, as
    ``torch.roll`` puts it."""
    gen = torch.Generator().manual_seed(3)
    src = torch.randint(-1000, 1000, grid + payload, generator=gen).to(dtype)
    other = src[..., :1] if payload else src      # a strided view
    got = ring_shift([src, other], [axis, axis])
    assert torch.equal(got[0], torch.roll(src, 1, dims=dim))
    assert torch.equal(got[1], torch.roll(other, 1, dims=dim))


def test_ring_shift_rejects_bad_input():
    x = torch.zeros((2, 2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        ring_shift([x], ["l"])
    with pytest.raises(ValueError):
        ring_shift([x, x], ["c"])
    with pytest.raises(ValueError):
        ring_shift([x] * 9, ["c"] * 9)
    with pytest.raises(ValueError):
        ring_shift([torch.zeros(4)], ["c"])


@pytest.mark.parametrize("p", [2, 4])
def test_skew_matches_jax(p):
    """Cannon's initial skew: the same gather on every block stack and the
    nnz table (JAX's ``_skew`` reads only the grid's side)."""
    x = np.arange(p * p * 3, dtype=np.int32).reshape(p, p, 3)
    nnz = np.arange(p * p, dtype=np.int64).reshape(p, p)
    m = trma.DistSpMat(row=torch.from_numpy(x), col=torch.from_numpy(x + 1),
                       val=torch.from_numpy(x).float(),
                       nnz=torch.from_numpy(nnz), gshape=(4 * p, 4 * p),
                       grid=ProcGrid.make(p, p, device="cpu"))
    for axis in ("c", "r"):
        got = trma._skew(m, axis)
        for stack, t in zip((x, x + 1, x.astype(np.float32), nnz), got):
            want = np.asarray(jrma._skew(jnp.asarray(stack),
                                         SimpleNamespace(pr=p), axis))
            np.testing.assert_array_equal(t.numpy(), want)
