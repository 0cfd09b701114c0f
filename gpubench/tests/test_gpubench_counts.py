"""The yardstick on hand-made graphs: the generator, the work counts, the
roofline counts and the plain references against scipy and numpy."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import connected_components, shortest_path

from gpubench.count import work
from gpubench.gen.rmat import assemble, make_graph
from gpubench.ref import bfs as ref_bfs
from gpubench.ref import mcl as ref_mcl
from gpubench.ref import spgemm as ref_spgemm
from gpubench.ref import spmm as ref_spmm

CPU = torch.device("cpu")


def graph(edges, n):
    r = torch.tensor([e[0] for e in edges], dtype=torch.int32)
    c = torch.tensor([e[1] for e in edges], dtype=torch.int32)
    return assemble(r, c, n, symmetrize=True, remove_self_loops=True)


def scipy_of(g):
    return sp.csr_matrix((g.val.numpy().astype(np.float64),
                          (g.row.numpy(), g.col.numpy())), shape=(g.n, g.n))


def random_graph(scale=8, seed=3, initiator="graph500"):
    return make_graph(dict(scale=scale, edgefactor=8, initiator=initiator,
                           symmetrize=True, remove_self_loops=True,
                           graph_seed=5), seed, CPU)


def test_assemble_sums_duplicates_and_drops_loops():
    g = graph([(0, 1), (1, 0), (2, 2), (1, 2)], 3)
    assert g.row.tolist() == [0, 1, 1, 2]
    assert g.col.tolist() == [1, 0, 2, 1]
    assert g.val.tolist() == [2.0, 2.0, 1.0, 1.0]
    assert g.row_ptr.tolist() == [0, 1, 3, 4]
    assert g.slots == 8


def test_seed_relabels_the_same_graph():
    a, b = random_graph(seed=1), random_graph(seed=2)
    assert a.nnz == b.nnz
    assert sorted(a.deg.tolist()) == sorted(b.deg.tolist())
    assert not torch.equal(a.row, b.row)
    assert (work.a2_products(a.row_ptr, a.col)
            == work.a2_products(b.row_ptr, b.col))


def test_products_of_a_path_and_of_a_random_graph():
    g = graph([(0, 1), (1, 2)], 3)           # degrees 1, 2, 1
    assert work.a2_products(g.row_ptr, g.col) == 1 + 4 + 1
    g = random_graph()
    s = scipy_of(g)
    want = int((np.diff(s.indptr) * np.bincount(s.indices,
                                                minlength=g.n)).sum())
    assert work.a2_products(g.row_ptr, g.col) == want


def test_component_edges():
    # a triangle, an edge, an isolated vertex
    g = graph([(0, 1), (1, 2), (0, 2), (3, 4)], 6)
    lab, edges = work.component_edges(g.row_ptr, g.row, g.col)
    assert lab.tolist() == [0, 0, 0, 3, 3, 5]
    assert edges[lab].tolist() == [3, 3, 3, 1, 1, 0]


def test_components_against_scipy():
    g = random_graph(scale=9, seed=4)
    lab = work.components(g.row, g.col, g.n)
    ncomp, want = connected_components(scipy_of(g), directed=False)
    assert len(torch.unique(lab)) == ncomp
    assert ref_mcl.partition_distance(lab, torch.from_numpy(want)) == 0


def test_work_counts():
    assert work.expand_work(10, 20, 100) == (12 * 130, 100)
    assert work.compress_work(100, 40) == (12 * 140, 100)
    assert work.ell_sum_work(50, 8, 9, 4) == (8 * 50 + 4 * 4 * 17, 400)
    assert work.ell_max_work(50, 8, 64, 3) == (3 * (200 + 8 * 64 * 8),
                                               3 * 50 * 64)
    peaks = {"hbm_bytes_per_s": 2.0, "fp32_flops_per_s": 10.0}
    assert work.bound_s(4, 10, peaks) == 2.0
    assert work.bound_s(4, 100, peaks) == 10.0


def test_ref_a2_against_scipy():
    g = random_graph(initiator="ssca")
    s = scipy_of(g)
    c = (s @ s).tocoo()
    blocks = ref_spgemm.row_blocks(g.row_ptr, g.col, g.row_ptr,
                                   max_products=997)
    assert len(blocks) > 3
    keys, vals = zip(*(ref_spgemm.a2_block(g, r0, r1) for r0, r1 in blocks))
    key, val = torch.cat(keys).numpy(), torch.cat(vals).numpy()
    order = np.lexsort((c.col, c.row))
    np.testing.assert_array_equal(key, (c.row * g.n + c.col)[order])
    np.testing.assert_array_equal(val, c.data[order])


def test_compare_a2_counts_faults():
    g = random_graph(initiator="ssca")
    k, v = ref_spgemm.a2_block(g, 0, g.n)
    row, col = (k // g.n).to(torch.int32), (k % g.n).to(torch.int32)
    val = v.float()
    ok = ref_spgemm.compare_a2(g, row, col, val, k.shape[0])
    assert ok["key_mismatch"] == 0 and ok["val_max_rel"] == 0.0
    assert ok["nnz_c"] == k.shape[0]
    bad = val.clone()
    bad[5] += 1
    assert ref_spgemm.compare_a2(g, row, col, bad, k.shape[0])[
        "val_max_rel"] > 0
    assert ref_spgemm.compare_a2(g, row, col, val, k.shape[0] - 3)[
        "key_mismatch"] == 3


def test_ref_bfs_against_scipy():
    g = random_graph(scale=9)
    dist = shortest_path(scipy_of(g), unweighted=True, indices=[7, 11])
    for i, root in enumerate((7, 11)):
        lv, par = ref_bfs.bfs(g.row_ptr, g.col, root)
        want = np.where(np.isinf(dist[i]), -1, dist[i]).astype(np.int64)
        np.testing.assert_array_equal(lv.numpy(), want)
    roots = [7, 11]
    lv, par = zip(*(ref_bfs.bfs(g.row_ptr, g.col, r) for r in roots))
    lv, par = torch.stack(lv), torch.stack(par)
    assert ref_bfs.compare_bfs(g, roots, par, lv) == {"level_mismatch": 0,
                                                      "bad_parent": 0}
    p2 = par.clone()
    v = int(torch.nonzero(lv[0] == 2)[0])
    p2[0, v] = roots[0]                       # the root is two levels up
    assert ref_bfs.compare_bfs(g, roots, p2, lv)["bad_parent"] == 1


def test_ref_spmm_against_numpy():
    g = random_graph(scale=8)
    x = torch.rand((g.n, 5), generator=torch.Generator().manual_seed(1))
    want = scipy_of(g) @ x.double().numpy()
    np.testing.assert_allclose(ref_spmm.spmm(g, x).numpy(), want,
                               rtol=1e-12)
    assert ref_spmm.compare_spmm(g, x, torch.from_numpy(want).float())[
        "y_max_rel"] < 1e-7


def test_ref_mcl_two_cliques():
    # two 5-cliques joined by one edge cluster apart once select prunes
    edges = [(i, j) for i in range(5) for j in range(i + 1, 5)]
    edges += [(i + 5, j + 5) for i, j in edges] + [(4, 5)]
    g = graph(edges, 10)
    p = dict(inflation=2.0, cutoff=1e-4, select=3, recover_num=3,
             recover_pct=0.9, eps=1e-3, max_iters=100)
    lab, it = ref_mcl.mcl(g, p)
    assert ref_mcl.partition_distance(
        lab, torch.tensor([0] * 5 + [5] * 5)) == 0
    assert 1 < it < 100


def test_partition_distance():
    a = torch.tensor([0, 0, 1, 1, 2])
    assert ref_mcl.partition_distance(a, torch.tensor([7, 7, 3, 3, 9])) == 0
    assert ref_mcl.partition_distance(a, torch.tensor([7, 7, 3, 9, 9])) == 1
    assert ref_mcl.partition_distance(a, torch.zeros(5, dtype=torch.long)) \
        == 3


@pytest.mark.parametrize("initiator", ["graph500", "ssca"])
def test_generator_initiator_corner(initiator):
    g = make_graph(dict(scale=10, edgefactor=16, initiator=initiator,
                        symmetrize=False, remove_self_loops=False,
                        graph_seed=1), 0, CPU)
    # unscrambled: the heaviest quadrant is the top-left corner's
    g0 = make_graph(dict(scale=10, edgefactor=16, initiator=initiator,
                         symmetrize=False, remove_self_loops=False,
                         graph_seed=1), 0, CPU)
    assert torch.equal(g.row, g0.row)
    assert float(g.val.sum()) == 16 * 1024


@pytest.mark.parametrize("ids", [[0, 1, 2, 3], [6, 2, 9, 5]])
def test_labellings_are_one_set_in_a_seed_order(ids):
    from gpubench.drivers._program import graphs
    from gpubench.gen.rmat import labelling_seed, make_graph
    cfg = {"graph": dict(scale=8, edgefactor=8, initiator="ssca",
                         symmetrize=True, remove_self_loops=True,
                         graph_seed=42)}
    mix = {"labellings": ids}

    def keys(seed):
        return [tuple(g.row[:50].tolist()) for g in graphs(cfg, mix, seed,
                                                            CPU)]
    a, b = keys(1), keys(2 ** 31 + 5)
    assert sorted(a) == sorted(b) and len(set(a)) == 4
    assert keys(1) == a
    want = [tuple(make_graph(cfg["graph"], labelling_seed(42, j), CPU)
                  .row[:50].tolist()) for j in ids]
    assert sorted(a) == sorted(want)
    (one,) = graphs(cfg, {}, 7, CPU)
    assert one.nnz == graphs(cfg, {}, 8, CPU)[0].nnz
