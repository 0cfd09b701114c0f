"""The streamed A² cell (``a2_stream.ssca22``): its CPU rehearsal with
``--trace 1`` reports its own per-layer metrics and the other cells'
report none of them; a digest off by one entry, by a checksum past its
limit, truncated, or with C's values under the wrong columns (the window
sort's value gather skipped) comes out ``correct: false``; the bfloat16
control fails.  On the card (``gpu``) all six metrics, the roofline at
most 100 %."""

import pytest
import torch

from gpubench.core import manifest
from gpubench.core.harness import run_cell
from gpubench.drivers import a2_stream
from gpubench.tests._tiny import CELLS, CPU
from gpubench.tests.test_gpubench_controls import _fails
from gpubench.tests.test_gpubench_harness import _run

CELL = "a2_stream.ssca22"
#: The cell's per-layer metrics; the CPU's trace has no device and no
#: peak memory, so there only the program's spans and the plan's counter
#: are read.
OWN = {"a2s.idle_pct", "a2s.window_sort_ms", "a2s.windows_ms",
       "a2s.kernels_roofline", "a2s.pad_ratio", "a2s.peak_gib"}
ON_THE_CPU = {"a2s.window_sort_ms", "a2s.windows_ms", "a2s.pad_ratio"}


def test_manifest_lists_the_six_for_this_cell_alone():
    bench = manifest.load_benchmark()
    assert {m["name"] for m in manifest.metrics_of(
        bench, CELL, "per_layer")} == OWN
    for cell in CELLS:
        assert not {m["name"] for m in manifest.metrics_of(
            bench, cell, "per_layer")} & OWN


def test_rehearsal_reports_its_metrics_and_no_other():
    line = run_cell(CELL, 2 ** 31 + 3, 0.5, True, CPU, 0.0, scale=10)[0]
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == ON_THE_CPU
    m = line["metrics"]
    assert m["a2s.pad_ratio"]["value"] > 1
    assert m["a2s.window_sort_ms"]["value"] > 0
    assert m["a2s.windows_ms"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_other_cells_report_none_of_them(cell, monkeypatch):
    line, _ = _run(cell, True, monkeypatch)
    assert line["correct"] is True
    assert not set(line["metrics"]) & OWN


def _off(how):
    """``spgemm_streamed_seg`` whose digest is off as ``how`` says."""
    real = a2_stream.spgemm_streamed_seg
    limit = manifest.traffic("a2_stream")["limits"]["checksum_rel"]

    def f(a, b, **kw):
        nnz, checksum, truncated, signed = real(a, b, **kw)
        if how == "one_entry_more":
            nnz += 1
        elif how == "checksum_past_limit":
            checksum *= 1 + 2 * limit
        else:
            truncated = True
        return nnz, checksum, truncated, signed
    return f


def _ungathered(val2d, dim, perm, *, out):
    """``torch.gather`` that skips the window sort's permutation."""
    return out.copy_(val2d)


@pytest.mark.parametrize("how", ["one_entry_more", "checksum_past_limit",
                                 "truncated", "values_ungathered"])
def test_a_digest_off_is_not_correct(how, monkeypatch):
    if how == "values_ungathered":
        monkeypatch.setattr(torch, "gather", _ungathered)
    else:
        monkeypatch.setattr(a2_stream, "spgemm_streamed_seg", _off(how))
    line, comp = _run(CELL, False, monkeypatch, scale=10)
    assert line["correct"] is False
    over = {k for k, (v, lim) in comp.items() if v > lim}
    assert over == {{"one_entry_more": "nnz_gap",
                     "checksum_past_limit": "checksum_rel",
                     "truncated": "truncated",
                     "values_ungathered": "signed_rel"}[how]}


def test_control_fails_at_a_tiny_scale():
    assert set(_fails(CELL, 10, 2, CPU)) == {"checksum_rel", "signed_rel"}


@pytest.mark.gpu
def test_card_reports_all_six(card):
    line = run_cell(CELL, 2 ** 31 + 5, 2.0, True, card, 0.0, scale=16)[0]
    assert line["correct"] is True
    assert set(line["metrics"]) == OWN
    assert 0 < line["metrics"]["a2s.kernels_roofline"]["value"] <= 100


@pytest.mark.gpu
def test_control_fails_on_the_card(card):
    assert set(_fails(CELL, None, 3, card)) == {"checksum_rel",
                                                 "signed_rel"}
