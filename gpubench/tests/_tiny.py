"""Tiny cells for the CPU tests: a cell's driver run on a graph of
2**scale vertices, without the window."""

from __future__ import annotations

import torch

from gpubench.core import manifest
from gpubench.gen.rmat import make_graph

CPU = torch.device("cpu")
CELLS = ("a2_keep.ssca20", "bfs64.g500", "mcl.ssca17", "spmm128.g500")


def parts(cell_name: str, scale: int, seed: int = 1, **settings):
    """(graph scrambled by ``seed``, config, traffic, driver module) of a
    cell at ``scale`` on the CPU; ``settings`` replace the configuration's
    MCL settings."""
    bench = manifest.load_benchmark()
    cell = manifest.cell(bench, cell_name)
    cfg = manifest.config(bench, cell["config"])
    cfg = dict(cfg, graph=dict(cfg["graph"], scale=scale))
    if settings:
        cfg["settings"] = dict(cfg["settings"],
                               mcl=dict(cfg["settings"]["mcl"], **settings))
    mix = manifest.traffic(cell["traffic"])
    return (make_graph(cfg["graph"], seed, CPU), cfg, mix,
            manifest.driver(mix["driver"]))


def compared(cell_name: str, scale: int, seed: int = 1, **settings) -> dict:
    """{name: (value, limit)} of one operation of the cell's driver."""
    _g, cfg, mix, drv_mod = parts(cell_name, scale, seed, **settings)
    drv = drv_mod.Driver(cfg, mix, seed, CPU)
    drv.warm()
    drv.op(0, False)
    drv.release()
    return drv.compare()
