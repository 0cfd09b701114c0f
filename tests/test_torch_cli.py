"""The port's command line (``combblas_tpu_torch/cli.py``) vs the JAX
package's, in process on files the tests write under ``tmp_path``.

``main(argv, device="cpu")`` must print the lines JAX's ``main`` prints,
outside the timings (``... 0.123s``) and the random draws (``gen``'s and
``galerkin``'s sizes follow the draw: those lines are held on their
fields and invariants).  Both register the same ten subcommands; the four
functions JAX leaves without a subcommand (``cmd_md``, ``cmd_fbfs``,
``cmd_fmis``, ``cmd_spgemm3d``) are called directly.
"""

import argparse
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from combblas_tpu import cli as jcli  # noqa: E402
from combblas_tpu.io.mtx import read_mtx as j_read_mtx  # noqa: E402
from combblas_tpu_torch import cli as tcli  # noqa: E402
from combblas_tpu_torch.io.binary import read_binary  # noqa: E402
from combblas_tpu_torch.io.mtx import read_mtx, write_mtx  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402

_SECS = re.compile(r"[ ,]*(in )?\d+\.\d+s$")


def untimed(text: str) -> list:
    return [_SECS.sub("", line) for line in text.strip().splitlines()]


def graph(n=36, edges=60, seed=5, weights=False):
    """A symmetric loop-free graph (two parts and isolated vertices)."""
    rng = np.random.default_rng(seed)
    d = np.zeros((n, n), np.float32)
    for part in (np.arange(0, n // 2), np.arange(n // 2, n - 3)):
        for _ in range(edges // 2):
            u, v = rng.choice(part, 2, replace=False)
            d[u, v] = d[v, u] = rng.choice([1.0, 2.0]) if weights else 1.0
    return d


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    out = {}
    for name, d in (("g", graph()), ("w", graph(weights=True, seed=6)),
                    ("b", (np.random.default_rng(7).random((20, 26)) < 0.12)
                     .astype(np.float32))):
        p = str(tmp / f"{name}.mtx")
        write_mtx(p, TCOO.from_dense(d, device="cpu"))
        out[name] = (p, d)
    out["dir"] = tmp
    return out


def both(capsys, argv):
    """(port lines, JAX lines) of one command line."""
    tcli.main(argv, device="cpu")
    got = capsys.readouterr().out
    jcli.main(argv)
    want = capsys.readouterr().out
    return untimed(got), untimed(want)


def test_same_subcommands(capsys):
    choices = []
    for main in (lambda a: tcli.main(a, device="cpu"), jcli.main):
        with pytest.raises(SystemExit):
            main(["no-such-command"])
        err = capsys.readouterr().err
        choices.append(re.search(r"choose from (.*)\)", err).group(1))
    assert choices[0] == choices[1]
    assert choices[0].count(",") == 9
    ported = {n for n in dir(tcli) if n.startswith("cmd_")}
    assert ported == {n for n in dir(jcli) if n.startswith("cmd_")}
    assert len(ported) == 14


@pytest.mark.parametrize("argv", [
    ["bfs", "{g}", "--root", "0"],
    ["bfs", "{g}", "--root", "20", "--dir-opt"],
    ["bfs", "{w}", "--root", "3", "--symmetrize"],
    ["bfs", "{g}", "--root", "5", "--dist"],
    ["cc", "{g}"],
    ["cc", "{w}", "--algo", "lacc"],
    ["cc", "{g}", "--dist"],
    ["rcm", "{g}"],
    ["match", "{b}"],
    ["match", "{b}", "--max"],
    ["match", "{w}", "--awpm"],
    ["bc", "{g}", "--batch", "8", "--batches", "2"],
    ["mcl", "{g}", "--select", "30"],
], ids=lambda a: "-".join(x.lstrip("-") for x in a if "{" not in x))
def test_command_lines_match_jax(capsys, files, argv):
    argv = [x.format(**{k: v[0] for k, v in files.items() if k != "dir"})
            for x in argv]
    got, want = both(capsys, argv)
    assert got == want


def test_mcl_dist_line(capsys, files):
    """``mcl --dist`` prints what ``mcl_dist`` on the default grid gives.
    JAX's ``mcl --dist`` cannot run on the test mesh (its default grid is
    2x4 and its SpGEMM needs a square grid), and ``mcl_dist`` adds no self
    loops, so the clusters differ from ``mcl``'s."""
    from combblas_tpu_torch.models.mcl import MCLParams, mcl_dist
    from combblas_tpu_torch.parallel.dist import DistSpMat
    from combblas_tpu_torch.parallel.grid import default_grid

    tcli.main(["mcl", files["g"][0], "--select", "30", "--dist"],
              device="cpu")
    got = capsys.readouterr().out.strip()
    a = read_mtx(files["g"][0], device="cpu")
    labels, iters = mcl_dist(DistSpMat.from_local(a, default_grid(
        device="cpu")), MCLParams(select=30))
    k = len(np.unique(labels.numpy()[:36]))
    assert got == f"mcl: {k} clusters in {iters} iterations"


def test_spgemm_matches_jax(capsys, files, tmp_path):
    """``spgemm`` prints JAX's shape and nnz and writes the same C (the
    sums may associate otherwise: values within rtol 1e-6)."""
    p = files["w"][0]
    got, want = both(capsys, ["spgemm", p, p, "-o", str(tmp_path / "c.mtx")])
    assert got == want
    c = read_mtx(str(tmp_path / "c.mtx"), device="cpu")
    jc = j_read_mtx(str(tmp_path / "c.mtx"))
    np.testing.assert_allclose(c.to_dense().numpy(), files["w"][1] @
                               files["w"][1], rtol=1e-6)
    assert int(c.nnz) == int(jc.nnz)
    tcli.main(["spgemm", p, "--semiring", "min_plus"], device="cpu")
    got = untimed(capsys.readouterr().out)
    jcli.main(["spgemm", p, "--semiring", "min_plus"])
    assert got == untimed(capsys.readouterr().out)


def test_gen_and_convert(capsys, tmp_path):
    """``gen`` draws from a torch generator (another graph than JAX's key
    gives): its line has JAX's fields and the file's nnz; ``convert`` of
    it prints JAX's line and writes the bytes JAX's ``convert`` writes."""
    b, m = str(tmp_path / "g.bin"), str(tmp_path / "g.mtx")
    tcli.main(["gen", "--scale", "6", "--seed", "3", "-o", b], device="cpu")
    line = capsys.readouterr().out.strip()
    a = read_binary(b, device="cpu")
    assert line == f"gen: rmat scale 6, nnz {int(a.nnz)}"
    assert a.shape == (64, 64)
    got, want = both(capsys, ["convert", b, "-o", m])
    assert got == [x.replace(m, m) for x in want]
    mine = open(m, "rb").read()
    jcli.main(["convert", b, "-o", m])
    capsys.readouterr()
    assert open(m, "rb").read() == mine
    np.testing.assert_array_equal(read_mtx(m, device="cpu").to_dense(),
                                  a.to_dense())


def test_galerkin_line(capsys, files, tmp_path):
    """``galerkin`` prints JAX's fields; the coarse shape is R's row count
    and R has one entry a fine vertex (its draw is the port's own)."""
    out = str(tmp_path / "c.mtx")
    tcli.main(["galerkin", files["g"][0], "--seed", "1", "--output", out],
              device="cpu")
    line = untimed(capsys.readouterr().out)[0]
    m = re.fullmatch(r"galerkin: coarse \((\d+), (\d+)\) nnz (\d+) "
                     r"\(R \((\d+), (\d+)\)\)", line)
    assert m, line
    k, k2, nnz, rk, n = (int(x) for x in m.groups())
    assert k == k2 == rk and n == 36 and 0 < k < n
    assert int(read_mtx(out, device="cpu").nnz) == nnz
    jcli.main(["galerkin", files["g"][0], "--seed", "1"])
    jline = untimed(capsys.readouterr().out)[0]
    assert re.fullmatch(r"galerkin: coarse \((\d+), \1\) nnz \d+ "
                        r"\(R \(\1, 36\)\)", jline)


def _ns(**kw):
    return argparse.Namespace(device="cpu", **kw)


def test_unregistered_commands_match_jax(capsys, files):
    g = files["w"][0]
    for fn, kw in (("cmd_md", dict(matrix=g)),
                   ("cmd_fbfs", dict(matrix=g, root=2, begin=1.5, end=2.5,
                                     symmetrize=False))):
        getattr(tcli, fn)(_ns(**kw))
        got = untimed(capsys.readouterr().out)
        getattr(jcli, fn)(argparse.Namespace(**kw))
        assert got == untimed(capsys.readouterr().out), fn


def test_cmd_fmis_and_spgemm3d(capsys, files):
    """``cmd_fmis``: the set's size in JAX's format, a filtered MIS of the
    graph.  ``cmd_spgemm3d``: two layers of the default grid, nnz equal to
    A²'s; one layer is no 3D grid."""
    tcli.cmd_fmis(_ns(matrix=files["w"][0], seed=0, begin=1.5, end=2.5))
    line = untimed(capsys.readouterr().out)[0]
    assert re.fullmatch(r"fmis: \|MIS\| \d+ / 36", line), line
    tcli.cmd_spgemm3d(_ns(matrix=files["g"][0], layers=2))
    line = untimed(capsys.readouterr().out)[0]
    d = files["g"][1]
    assert line == f"spgemm3d[layers=2]: nnz {np.count_nonzero(d @ d)}"
    with pytest.raises(ValueError):
        tcli.cmd_spgemm3d(_ns(matrix=files["g"][0], layers=1))
