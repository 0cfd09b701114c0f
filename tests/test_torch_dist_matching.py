"""The port's bipartite matchings on the block grid
(``parallel/matching.py``) vs the JAX package's on the virtual CPU mesh,
on 1x1, 2x2, 2x4 and 4x2 grids (the chunk layouts of the row- and
column-space results differ on grids that are not square).

Tolerances: every mate vector exact at its padded length (padding slots
included), ``init=`` and AWPM's weighted rounds too; the helpers' outputs
(one proposal, one BFS level, one dominant round) exact.  On the true rows
and columns the grid results also equal the port's local functions (as
JAX's equal JAX's local ones).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from combblas_tpu.parallel import matching as jpm  # noqa: E402
from combblas_tpu_torch.models import matching as tm  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402
from combblas_tpu_torch.parallel import matching as tpm  # noqa: E402
from tests.test_torch_dist import dist_pair  # noqa: E402
from tests.test_torch_matching import bipartite, same, same_mates  # noqa

GRIDS = [(1, 1), (2, 2), (2, 4), (4, 2)]
SHAPES = [(21, 26, 0.15, 11), (30, 17, 0.2, 12)]


def local(d):
    return TCOO.from_dense(d, device="cpu")


def same_true(t, want, m, n):
    """Grid mates on the true rows / columns == the local mates."""
    np.testing.assert_array_equal(t[0][:m].numpy(), want[0].numpy())
    np.testing.assert_array_equal(t[1][:n].numpy(), want[1].numpy())


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_dist_bp_maximal_matches_jax(grid, shape):
    d = bipartite(*shape)
    j, t = dist_pair(d, *grid)
    got = tpm.dist_bp_maximal(t)
    same_mates(got, jpm.dist_bp_maximal(j))
    same_true(got, tm.bp_maximal_matching(local(d)), *d.shape)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_dist_bp_maximum_matches_jax(grid, shape):
    d = bipartite(*shape)
    j, t = dist_pair(d, *grid)
    got = tpm.dist_bp_maximum(t)
    same_mates(got, jpm.dist_bp_maximum(j))
    same_true(got, tm.bp_maximum_matching(local(d)), *d.shape)


@pytest.mark.parametrize("grid", [(2, 4), (4, 2)])
def test_dist_bp_maximum_init_matches_jax(grid):
    """``init=``: the greedy matching with its first matched pair undone."""
    d = bipartite(*SHAPES[0])
    j, t = dist_pair(d, *grid)
    mr, mc = (x.clone() for x in tpm.dist_bp_maximal(t))
    r = int(torch.nonzero(mr >= 0)[0])
    mc[mr[r]] = -1
    mr[r] = -1
    got = tpm.dist_bp_maximum(t, init=(mr, mc))
    same_mates(got, jpm.dist_bp_maximum(
        j, init=(jnp.asarray(mr.numpy()), jnp.asarray(mc.numpy()))))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("complete", [True, False])
@pytest.mark.parametrize("ties", [False, True])
def test_dist_awpm_matches_jax(grid, complete, ties):
    d = bipartite(*SHAPES[1], ties=ties)
    j, t = dist_pair(d, *grid)
    got = tpm.dist_awpm(t, complete=complete)
    same_mates(got, jpm.dist_awpm(j, complete=complete))
    same_true(got, tm.awpm(local(d), complete=complete), *d.shape)


@pytest.mark.parametrize("grid", GRIDS)
def test_dist_helpers_match_jax(grid):
    """One proposal, one dominant round and one alternating-BFS level from
    a half-built matching, in JAX's row- and column-space layouts."""
    d = bipartite(*SHAPES[0])
    j, t = dist_pair(d, *grid)
    b = tpm._Blocks(t)
    mr, mc = tpm.dist_bp_maximal(t)
    mr, mc = mr.clone(), mc.clone()
    mr[: b.m_pad // 2] = -1         # free half the rows and their mates
    mc[(mc >= 0) & (mc < b.m_pad // 2)] = -1
    jr, jc = jnp.asarray(mr.numpy()), jnp.asarray(mc.numpy())
    same(tpm._dist_propose(b, mr, mc), jpm._dist_propose(j, jr, jc))
    tcc, tcr = tpm._dist_dominant(b, mr, mc)
    jcc, jcr = jpm._dist_dominant(j, jr, jc)
    same(tcc, jcc)
    same(tcr, jcr)
    front = (mr < 0) & (torch.arange(b.m_pad) < d.shape[0])
    vis = torch.zeros(b.n_pad, dtype=torch.bool)
    vis[::3] = True
    same(tpm._dist_alt_level(b, front, vis),
         jpm._dist_alt_level(j, jnp.asarray(front.numpy()),
                             jnp.asarray(vis.numpy())))
