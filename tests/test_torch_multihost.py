"""The port's ``parallel/multihost.py``: the single-process case of
``tests/test_multihost.py`` (no-op join, the pod grid equal to the default
grid, ``global_put`` round trips), and a two-process ``gloo`` join on the
loopback address, where ``pod_grid`` builds the grid across both processes
(``tests/test_torch_pod.py`` runs the slice on such grids)."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from combblas_tpu_torch.ops.coo import SpCOO  # noqa: E402
from combblas_tpu_torch.parallel.dist import DistSpMat  # noqa: E402
from combblas_tpu_torch.parallel.grid import default_grid  # noqa: E402
from combblas_tpu_torch.parallel.multihost import (  # noqa: E402
    global_put,
    initialize_multihost,
    is_coordinator,
    pod_grid,
)

REPO = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT_SECS = 120


def test_initialize_noop_single_process(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert initialize_multihost() == 1
    assert not torch.distributed.is_initialized()
    assert is_coordinator()


@pytest.mark.parametrize("layers", [1, 2])
def test_pod_grid_matches_default(layers):
    g = pod_grid(layers=layers, device="cpu")
    assert g == default_grid(layers=layers, device="cpu")
    assert g.is3d == (layers > 1) and g.layers == layers
    assert g.nprocs == layers


def test_pod_grid_sizes():
    g = pod_grid(pr=2, pc=4, device="cpu")
    assert (g.pr, g.pc, g.layers, g.nprocs) == (2, 4, 1, 8)


def test_global_put_roundtrip():
    g = pod_grid(device="cpu")
    x = np.arange(g.nprocs * 4, dtype=np.float32)
    got = global_put(x, g)
    assert got.device == g.device
    np.testing.assert_array_equal(got.numpy(), x)
    # and through a matrix constructor on the pod grid (degenerate = normal)
    d = np.eye(8, dtype=np.float32)
    a = DistSpMat.from_local(SpCOO.from_dense(d, device="cpu"), g)
    np.testing.assert_array_equal(a.to_dense(), d)


_WORKER = """
import sys
import torch.distributed as dist
from combblas_tpu_torch.parallel.multihost import (
    initialize_multihost, is_coordinator, pod_grid)

addr, rank = sys.argv[1], int(sys.argv[2])
size = initialize_multihost(addr, 2, rank)
assert initialize_multihost() == size  # joined: the group's size
g = pod_grid(pr=2, pc=2, device="cpu")
built = (g.nproc, g.rank, *g.local_shape(), *g.origin()) == (
    2, dist.get_rank(), 1, 2, dist.get_rank(), 0)
ranks = [None, None]
dist.all_gather_object(ranks, dist.get_rank())
print("JOIN", size, dist.get_rank(), int(is_coordinator()), int(built),
      *ranks, flush=True)
dist.destroy_process_group()
"""


def test_two_process_gloo_join():
    """Two CPU processes joined over TCP on 127.0.0.1 (``gloo``): world size
    2, ranks {0, 1}, one coordinator, and ``pod_grid`` building the 2x2
    grid across both, each process holding its block row.  Each process is
    bounded by its own timeout; on expiry both are killed."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env.pop("MASTER_ADDR", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, f"127.0.0.1:{port}", str(rank)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=JOIN_TIMEOUT_SECS)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{err[-3000:]}"
    lines = [next(ln.split() for ln in out.splitlines()
                  if ln.startswith("JOIN")) for _rc, out, _err in outs]
    size, rank, coord, built, *gathered = zip(
        *[[int(x) for x in ln[1:]] for ln in lines])
    assert size == (2, 2)
    assert sorted(rank) == [0, 1]
    assert sum(coord) == 1 and coord[rank.index(0)] == 1
    assert built == (1, 1)
    assert gathered == [(0, 0), (1, 1)]  # every rank saw ranks 0 and 1
