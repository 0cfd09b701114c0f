"""The port's block-grid ownership across processes (``parallel/grid.py``)
against the JAX package's rule: ``jax.devices()`` is process-major and
``ProcGrid.make`` reshapes it row-major to (layers, pr, pc), so process p
holds the blocks at raster positions [p·B/P, (p+1)·B/P).  Every rank's
``ProcGrid`` is built in one process (no group is joined), for P in
{1, 2, 4, 8} on (2, 2, 2), (2, 4, 4) and (4, 2, 2); a share that is not a
box raises ``ValueError``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from combblas_tpu_torch.parallel.grid import ProcGrid  # noqa: E402

SHAPES = [(2, 2, 2), (2, 4, 4), (4, 2, 2)]


def jax_owners(shape, nproc):
    """The process of every block: the device list of ``nproc`` processes
    (their devices in process order) reshaped as the JAX grid does."""
    blocks = int(np.prod(shape))
    devices = np.arange(blocks)
    return (devices // (blocks // nproc)).reshape(shape)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("nproc", [1, 2, 4, 8])
def test_layered_ownership_matches_jax(shape, nproc):
    """``local_shape3`` / ``origin3`` / ``owner3`` and the stacks' box
    equal the JAX rule for every rank; (2, 2, 2) over 8 is a run of one
    block, the TPU's own layout.  A one-layer grid's 2D ``local_shape`` /
    ``origin`` / ``owner`` are those of layer 0's."""
    l, pr, pc = shape
    owners = jax_owners(shape, nproc)
    for rank in range(nproc):
        g = ProcGrid.make(pr, pc, layers=l, device="cpu", nproc=nproc,
                          rank=rank)
        (t0, r0, c0), (ll, lr, lc) = g.origin3(), g.local_shape3()
        mine = np.zeros(shape, bool)
        mine[t0:t0 + ll, r0:r0 + lr, c0:c0 + lc] = True
        np.testing.assert_array_equal(mine, owners == rank)
        for t, i, j in np.ndindex(*shape):
            assert g.owner3(t, i, j) == owners[t, i, j]
    if shape == (2, 2, 2) and nproc == 8:
        assert ProcGrid.make(2, 2, layers=2, device="cpu", nproc=8,
                             rank=5).local_shape3() == (1, 1, 1)
    if nproc <= pr * pc:
        owners2 = jax_owners((pr, pc), nproc)
        for rank in range(nproc):
            g = ProcGrid.make(pr, pc, device="cpu", nproc=nproc, rank=rank)
            (r0, c0), (lr, lc) = g.origin(), g.local_shape()
            assert g.local_shape3() == (1, lr, lc)
            assert g.origin3() == (0, r0, c0)
            np.testing.assert_array_equal(
                owners2[r0:r0 + lr, c0:c0 + lc], rank)
            for i, j in np.ndindex(pr, pc):
                assert g.owner(i, j) == owners2[i, j]


@pytest.mark.parametrize("shape, nproc", [((3, 2, 2), 2), ((3, 2, 2), 8),
                                          ((2, 2, 2), 3), ((2, 4, 4), 6)])
def test_non_box_split_raises(shape, nproc):
    """A share that cuts a layer ((3, 2, 2) over 2: 6 blocks, a layer and
    a half; over 8: 1.5 blocks) or does not divide the blocks raises."""
    l, pr, pc = shape
    with pytest.raises(ValueError):
        ProcGrid.make(pr, pc, layers=l, device="cpu", nproc=nproc, rank=0)


def test_layered_pod_has_no_2d_share():
    """A layered grid over processes has no 2D share: ``local_shape``
    raises, and ``flat()`` is the one-layer (layers·pr, pc) grid whose
    ownership is the layered grid's."""
    g = ProcGrid.make(2, 2, layers=2, device="cpu", nproc=4, rank=3)
    with pytest.raises(ValueError):
        g.local_shape()
    f = g.flat()
    assert (f.pr, f.pc, f.layers, f.nproc, f.rank) == (4, 2, 1, 4, 3)
    assert f.origin() == (3, 0) and g.origin3() == (1, 1, 0)
