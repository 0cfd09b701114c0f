"""The control of each cell, the plain reference computed one precision
down (bfloat16 for the float32 the configurations state) and put in the
program's place, comes out not correct: at a tiny scale on the CPU here,
and on the card at the cell's own size (``gpu``; the readings that set
the limits come from ``gpubench/controls.py`` on the card)."""

import pytest

from gpubench.core import manifest
from gpubench.gen.rmat import make_graph
from gpubench.tests._tiny import CELLS, CPU


def _fails(cell, scale, seed, dev):
    """The control's numbers that exceed their limits."""
    bench = manifest.load_benchmark()
    entry = manifest.cell(bench, cell)
    cfg = manifest.config(bench, entry["config"])
    if scale is not None:
        cfg = dict(cfg, graph=dict(cfg["graph"], scale=scale))
    mix = manifest.traffic(entry["traffic"])
    g = make_graph(cfg["graph"], seed, dev)
    nums = manifest.driver(mix["driver"]).control(g, cfg, mix, seed, dev)
    return {k: v for k, v in nums.items() if v > mix["limits"][k]}


#: MCL's control fails by not converging: at the cell's size its bfloat16
#: chaos stays above eps for the 100 iterations (78-79 past the float64
#: reference, PERF.md), while at the scales a CPU test can hold (2^9-2^10
#: vertices) it converges within 0-1 iterations of it on most seeds.  So
#: MCL's control is tested on the card only, at the cell's own size.
TINY = [c for c in CELLS if not c.startswith("mcl")]


@pytest.mark.parametrize("cell", TINY)
def test_control_fails_at_a_tiny_scale(cell):
    over = _fails(cell, 10, 2, CPU)
    assert over, f"the control of {cell} passed every limit"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell, card):
    assert _fails(cell, None, 3, card)
