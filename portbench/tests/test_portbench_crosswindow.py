"""The readers of the ``-U`` cell's cross-window metrics
(``crosswindow.*``) on synthetic runs, beside the stage readers of
``test_portbench_spans.py`` and with its fixtures, and the cell itself."""

import json
from pathlib import Path

import pytest

from portbench.core import cell as cells
from portbench.core.readings import GIB
from portbench.tests.test_portbench_spans import (COMPRESS, DECOMPRESS, HALF,
                                                  OPS, reader, run_of)

ROOT = Path(__file__).resolve().parents[2]
CELL = "lzma-L7-U.kernel-trees"

# two -U windows' stages on top of the stage fixtures' compress dicts
U_STAGES = [{"compress.cross_find": 0.5, "compress.cross_index": 12.0},
            {"compress.cross_find": 30.0, "compress.cross_index": 0.0}]
EXPECTED = {
    "crosswindow.find_ms_per_gib": (0.5 + 30.0) / 2,    # 2 GiB compressed
    "crosswindow.index_ms_per_gib": 12.0 / 2,
}

# the counters of three -U windows: the first has no earlier window
U_COUNTS = [
    {"cross_anchors": 0, "cross_hits": 0, "cross_matches": 0,
     "cross_bytes": 0, "cross_left_bytes": 0},
    {"cross_anchors": 900, "cross_hits": 850, "cross_matches": 40,
     "cross_bytes": HALF // 2, "cross_left_bytes": 3000},
    {"cross_anchors": 880, "cross_hits": 870, "cross_matches": 52,
     "cross_bytes": HALF, "cross_left_bytes": 2000},
]


def unlimited_compress():
    return [dict(s, main_ms={**s["main_ms"], **u})
            for s, u in zip(COMPRESS, U_STAGES)]


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_stage_reader_value(name):
    assert reader(name)(run_of(unlimited_compress() + DECOMPRESS)) == \
        pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_stage_reader_is_none_without_its_stage(name):
    """The lookahead's dicts and the parent's ``-U`` windows (one
    ``compress.cross`` stage) have no such stage; a decompress has no
    compress dict."""
    parent = [dict(s, main_ms={"compress.cross": 12.5, **s["main_ms"]})
              for s in COMPRESS]
    for stats in ([], COMPRESS, DECOMPRESS, parent):
        assert reader(name)(run_of(stats)) is None


def test_covered_pct_reads_the_windows_counters():
    """100 x the summed ``cross_bytes`` of the compress windows over the
    compress input (2 GiB); None on dicts without the counters (the
    lookahead's, the parent's ``-U`` windows) and without a compress."""
    read = reader("crosswindow.covered_pct")
    u = [dict(COMPRESS[0], chunk=i, **c) for i, c in enumerate(U_COUNTS)]
    assert read(run_of(u + DECOMPRESS)) == \
        pytest.approx(100.0 * (HALF // 2 + HALF) / (2 * GIB))
    parent = [{k: v for k, v in s.items() if not k.startswith("cross_")}
              for s in u]
    for stats in ([], COMPRESS + DECOMPRESS, parent):
        assert read(run_of(stats)) is None
    assert read(run_of(u, ops=[o for o in OPS
                               if o["kind"] == "decompress"])) is None


def test_new_entries_name_their_readers_and_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in EXPECTED:
        m = entries[name]
        assert (m["source"], m["unit"], m["better"], m["moves"]) == \
            ("program_span", "ms/GiB", "lower", "compress_MBps")
    m = entries["crosswindow.covered_pct"]
    assert (m["source"], m["unit"], m["better"], m["moves"]) == \
        ("program_span", "%", "higher", "ratio")
    for name in [*EXPECTED, "crosswindow.covered_pct"]:
        assert entries[name]["workloads"] == [CELL]
        assert entries[name]["layer"] == "cross-window index"


def test_unlimited_cell():
    cell = cells.resolve(CELL, ROOT)
    names = [m.name for m in cell.per_layer]
    assert names[-3:] == ["crosswindow.index_ms_per_gib",
                          "crosswindow.find_ms_per_gib",
                          "crosswindow.covered_pct"]
    assert not any(n.startswith(("literal.", "kernels.")) for n in names)
    assert {m.name for m in cell.end_to_end} == {
        "compress_MBps", "decompress_MBps", "ratio", "setup_s"}
    assert cell.chips == 1
    s = cell.config["settings"]
    assert s["unlimited"] and s["method"] == "lzma"
    p = cell.traffic["params"]
    # a tree spans 1.5 windows, and the file is nine whole windows
    assert p["tree_bytes"] * 2 == 3 * s["max_chunk"]
    assert p["trees"] * p["tree_bytes"] == 9 * s["max_chunk"]
    assert cell.traffic["ops"] == ["compress", "decompress"]
    assert cell.traffic["reference_sample"]["chunks_per_file"] == 1
