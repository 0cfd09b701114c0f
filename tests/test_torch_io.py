"""The port's I/O (``io/mtx.py``, ``io/binary.py``, ``io/labels.py``,
``io/parallel.py``) vs the JAX package's, on files the tests write under
``tmp_path``.

Tolerances: every written file equal to JAX's byte for byte (Matrix
Market, binary matrices and vectors, labelled tuples, and the block-
streamed writes of 1x1, 2x2, 2x4 and 4x2 grids); every read matrix equal
to JAX's slot for slot (pads included), every read block stack too.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from combblas_tpu import SpCOO as JCOO  # noqa: E402
from combblas_tpu.io import binary as jbin  # noqa: E402
from combblas_tpu.io import labels as jlab  # noqa: E402
from combblas_tpu.io import mtx as jmtx  # noqa: E402
from combblas_tpu.io import parallel as jpar  # noqa: E402
from combblas_tpu.ops.spvec import SpVec as JVec  # noqa: E402
from combblas_tpu_torch.io import binary as tbin  # noqa: E402
from combblas_tpu_torch.io import labels as tlab  # noqa: E402
from combblas_tpu_torch.io import mtx as tmtx  # noqa: E402
from combblas_tpu_torch.io import parallel as tpar  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402
from combblas_tpu_torch.ops.spvec import SpVec as TVec  # noqa: E402
from tests.test_coo import rand_sparse  # noqa: E402
from tests.test_torch_dist import assert_same_blocks, dist_pair  # noqa: E402
from tests.test_torch_dist import jgrid, tgrid  # noqa: E402

GRIDS = [(1, 1), (2, 2), (2, 4), (4, 2)]

#: Matrix Market files of every header form the readers take.
FILES = {
    "general": "%%MatrixMarket matrix coordinate real general\n% c\n"
               "3 4 4\n1 1 1.5\n2 3 -2\n3 4 0.25\n1 2 7\n",
    "symmetric": "%%MatrixMarket matrix coordinate real symmetric\n"
                 "4 4 4\n1 1 2\n2 1 3\n4 2 -1\n3 3 5\n",
    "skew": "%%MatrixMarket matrix coordinate real skew-symmetric\n"
            "3 3 2\n2 1 4\n3 1 -2.5\n",
    "pattern": "%%MatrixMarket matrix coordinate pattern general\n\n"
               "5 5 3\n1 5\n2 2\n5 1\n",
    "integer": "%%MatrixMarket matrix coordinate integer general\n"
               "2 3 3\n1 1 3\n2 3 9\n1 3 -4\n",
    "headerless": "4 3 3\n1 1 0.5\n4 3 2\n2 2 1\n",
    "duplicates": "%%MatrixMarket matrix coordinate real general\n"
                  "3 3 4\n1 1 1\n1 1 2\n3 2 1\n3 2 0.5\n",
    "empty": "%%MatrixMarket matrix coordinate real general\n3 3 0\n",
}


def same_coo(t, j):
    """Slot for slot, pads included; the port's nnz is int64."""
    for f in ("row", "col", "val"):
        x, y = getattr(t, f).cpu().numpy(), np.asarray(getattr(j, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y)
    assert int(t.nnz) == int(j.nnz) and t.shape == j.shape


def mats(seed=1, m=19, n=23, density=0.3):
    d = rand_sparse(m, n, density, seed=seed)
    d[d > 0] = np.round(d[d > 0] * 977) / 61     # values with many digits
    return d, TCOO.from_dense(d, device="cpu"), JCOO.from_dense(d)


def write_file(tmp_path, name):
    p = tmp_path / f"{name}.mtx"
    p.write_text(FILES[name])
    return str(p)


@pytest.mark.parametrize("name", sorted(FILES))
def test_read_mtx_matches_jax(tmp_path, name):
    p = write_file(tmp_path, name)
    for x, y in zip(tmtx.read_mtx_arrays(p)[:3], jmtx.read_mtx_arrays(p)[:3]):
        np.testing.assert_array_equal(x, y)
    assert tmtx.read_mtx_arrays(p)[3] == jmtx.read_mtx_arrays(p)[3]
    same_coo(tmtx.read_mtx(p, device="cpu"), jmtx.read_mtx(p))
    same_coo(tmtx.read_mtx(p, capacity=64, device="cpu"),
             jmtx.read_mtx(p, capacity=64))


def test_read_mtx_rejects_what_jax_rejects(tmp_path):
    for text in ("not a matrix\n1 2\n",
                 "%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n",
                 "%%MatrixMarket matrix coordinate real general\n"
                 "2 2 3\n1 1 1\n"):
        p = tmp_path / "bad.mtx"
        p.write_text(text)
        with pytest.raises(ValueError):
            jmtx.read_mtx_arrays(str(p))
        with pytest.raises(ValueError):
            tmtx.read_mtx_arrays(str(p))


def test_native_parser_matches_numpy(tmp_path, monkeypatch):
    """The C++ scanner built from ``csrc/mmparse.cpp`` and loaded through
    ``ctypes`` parses as the numpy parser does."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build csrc/mmparse.cpp")
    lib = tmp_path / "libmmparse.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-fPIC", "-shared",
                    "-pthread", "-o", str(lib),
                    str(Path(__file__).resolve().parents[1] / "csrc" /
                        "mmparse.cpp")],
                   check=True, timeout=300)
    monkeypatch.setattr(tmtx, "_NATIVE", tmtx._load_native(str(lib)))
    monkeypatch.setattr(tmtx, "_NATIVE_TRIED", True)
    for name in ("general", "symmetric", "pattern", "integer"):
        p = write_file(tmp_path, name)
        got, want = tmtx.read_mtx_arrays(p), tmtx._read_mtx_numpy(p)
        assert got[3] == want[3]
        t = TCOO.from_arrays(*got[:3], got[3], device="cpu")
        w = TCOO.from_arrays(*want[:3], want[3], device="cpu")
        assert torch.equal(t.to_dense(), w.to_dense()), name


@pytest.mark.parametrize("comment", ["", "written by a test"])
def test_write_mtx_bytes_match_jax(tmp_path, comment):
    _, t, j = mats()
    tmtx.write_mtx(str(tmp_path / "t.mtx"), t, comment)
    jmtx.write_mtx(str(tmp_path / "j.mtx"), j, comment)
    assert (tmp_path / "t.mtx").read_bytes() == \
        (tmp_path / "j.mtx").read_bytes()
    same_coo(tmtx.read_mtx(str(tmp_path / "t.mtx"), device="cpu"),
             jmtx.read_mtx(str(tmp_path / "j.mtx")))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_binary_bytes_match_jax(tmp_path, dtype):
    d, _, _ = mats(seed=2)
    d = d.astype(dtype) if dtype != np.int32 else (d * 10).astype(dtype)
    r, c = np.nonzero(d)
    t = TCOO.from_arrays(r, c, d[r, c], d.shape, dtype=dtype, device="cpu")
    j = JCOO.from_arrays(r, c, d[r, c], d.shape, dtype=dtype)
    tbin.write_binary(str(tmp_path / "t.bin"), t)
    jbin.write_binary(str(tmp_path / "j.bin"), j)
    assert (tmp_path / "t.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()
    same_coo(tbin.read_binary(str(tmp_path / "t.bin"), device="cpu"),
             jbin.read_binary(str(tmp_path / "j.bin")))


def test_binary_rejects_bad_magic(tmp_path):
    p = tmp_path / "garbage.bin"
    p.write_bytes(b"NOTMAGIC" + bytes(32))
    for read in (tbin.read_binary, tbin.read_vec_binary):
        with pytest.raises(ValueError):
            read(str(p), device="cpu")


def test_vec_binary_bytes_match_jax(tmp_path):
    idx = np.array([9, 2, 40, 17], np.int32)
    val = np.array([1.5, -2.0, 0.125, 7.0], np.float32)
    tv = TVec.from_arrays(idx, val, 50, device="cpu")
    jv = JVec.from_arrays(idx, val, 50)
    tbin.write_vec_binary(str(tmp_path / "t.vbin"), tv)
    jbin.write_vec_binary(str(tmp_path / "j.vbin"), jv)
    assert (tmp_path / "t.vbin").read_bytes() == \
        (tmp_path / "j.vbin").read_bytes()
    back = tbin.read_vec_binary(str(tmp_path / "t.vbin"), device="cpu")
    want = jbin.read_vec_binary(str(tmp_path / "j.vbin"))
    np.testing.assert_array_equal(back.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(back.val.numpy(), np.asarray(want.val))
    assert int(back.nnz) == int(want.nnz) and back.length == want.length


def test_labeled_tuples_match_jax(tmp_path):
    p = tmp_path / "g.txt"
    p.write_text("# proteins\nprotA protB 1.5\nprotB protC 2.0\n\n"
                 "% note\nprotC protA 0.5\nprotD protA\nlonely\n"
                 "protB protB 3.25\n")
    ta, tl = tlab.read_labeled_tuples(str(p), device="cpu")
    ja, jl = jlab.read_labeled_tuples(str(p))
    assert tl == jl
    same_coo(ta, ja)
    tu, _ = tlab.read_labeled_tuples(str(p), weighted=False, device="cpu")
    ju, _ = jlab.read_labeled_tuples(str(p), weighted=False)
    same_coo(tu, ju)
    tlab.write_labeled_tuples(str(tmp_path / "t.txt"), ta, tl)
    jlab.write_labeled_tuples(str(tmp_path / "j.txt"), ja, jl)
    assert (tmp_path / "t.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()


@pytest.mark.parametrize("grid", GRIDS)
def test_parallel_writes_match_jax(tmp_path, grid):
    d, _, _ = mats(seed=3, m=22, n=18)
    j, t = dist_pair(d, *grid)
    tpar.parallel_write_mtx(str(tmp_path / "t.mtx"), t, comment="a\nb")
    jpar.parallel_write_mtx(str(tmp_path / "j.mtx"), j, comment="a\nb")
    assert (tmp_path / "t.mtx").read_bytes() == \
        (tmp_path / "j.mtx").read_bytes()
    tpar.parallel_write_binary(str(tmp_path / "t.bin"), t)
    jpar.parallel_write_binary(str(tmp_path / "j.bin"), j)
    assert (tmp_path / "t.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()
    back = tpar.parallel_read_mtx(str(tmp_path / "t.mtx"), tgrid(*grid))
    assert_same_blocks(back, jpar.parallel_read_mtx(
        str(tmp_path / "j.mtx"), jgrid(*grid)), exact=True)
    assert_same_blocks(back, t, exact=True)
    np.testing.assert_array_equal(
        tbin.read_binary(str(tmp_path / "t.bin"),
                         device="cpu").to_dense().numpy(), d)


def test_parallel_read_capacity_matches_jax(tmp_path):
    d, t, _ = mats(seed=4)
    tmtx.write_mtx(str(tmp_path / "a.mtx"), t)
    got = tpar.parallel_read_mtx(str(tmp_path / "a.mtx"), tgrid(2, 2),
                                 capacity=64)
    want = jpar.parallel_read_mtx(str(tmp_path / "a.mtx"), jgrid(2, 2),
                                  capacity=64)
    assert got.capacity == 64
    assert_same_blocks(got, want, exact=True)
