"""The comparison that decides ``correct``: a clean run is correct, and
each fault a cell can have (``core/faults.py``), planted under the timed
path, makes it false.  Runs go through ``runner.run_cell`` with the
chip check skipped, on the CPU (or, marked ``cuda``, on the card), at
sizes a test run holds: the traffic's sizes cut, one file a window."""

import time
from pathlib import Path

import pytest

from portbench.core import cell as cells, runner

ROOT = Path(__file__).resolve().parents[2]

SEED = 2**32 + 99

# (workload, faults the cell can have).  "rans-L7.vm-1gib", the VM-image
# mix that no cell runs yet, is the Silesia cell with that mix's content;
# "@mesh4": the workload on the automatic mesh of four cards, stating
# that the mesh writes one card's archive, as a four-card configuration
# would
CELLS = {
    "rans-L7.vm-1gib": ["control", "answer", "token", "stale", "half"],
    "lzma-L7.kernel-tar": ["control", "answer", "token", "stale", "half"],
    "rans-L7.silesia": ["control", "answer", "token", "stale", "half"],
    "rans-L7.vm-1gib@mesh4": ["control", "answer", "token", "stale", "half",
                              "exchange"],
}


def resolve(workload: str):
    if workload != "rans-L7.vm-1gib":
        return cells.resolve(workload)
    c = cells.resolve("rans-L7.silesia")
    c.name, c.traffic = workload, cells.load_traffic(ROOT, "vm-1gib")
    c.generator = cells.load_generator(ROOT, c.traffic["generator"])
    return c


def small_cell(workload: str, monkeypatch, device: str = "cpu"):
    name, mesh4, _ = workload.partition("@mesh4")
    c = resolve(name)
    if mesh4:
        c.chips = 4
        c.config["settings"]["use_mesh"] = None
        c.config["same_archive_as"] = {"use_mesh": False}
    p = c.traffic["params"]
    if "size" in p:
        p["size"] = 4 << 20
    for f in p.get("files", []):
        f["size"] //= 256
    if "vm" in workload:
        c.config["settings"]["max_chunk"] = 1 << 20
    if c.chips > 1 and device == "cpu":
        from lrzip_next_tpu_torch.parallel import mesh
        m = mesh.make_mesh(devices=["cpu"] * c.chips)
        monkeypatch.setattr(mesh, "pipeline_mesh", lambda *_: m)
        c.config["settings"]["use_mesh"] = True
    return c


def run(c, fault=None, device="cpu"):
    lines = []
    out = runner.run_cell(c, SEED, 0.1, False, time.perf_counter(),
                          device=device, fault=fault, log=lines.append,
                          report=lambda m: None)
    assert out is not None, lines
    return out, lines


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_clean_runs_are_correct(workload, monkeypatch):
    out, lines = run(small_cell(workload, monkeypatch))
    assert out["correct"], lines
    assert out["attempted"] >= 1 and out["failed"] == 0
    checks = out["checks"]
    assert list(out)[-1] == "checks"
    assert all(v["value"] == 0 and v["limit"] == 0 for v in checks.values())
    assert lines[-len(checks):] == [
        f"check {n} 0 limit 0" for n in checks]
    if workload.endswith("@mesh4"):
        assert "same_archive_bad_files" in checks


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w, fs in sorted(CELLS.items()) for f in fs])
def test_each_fault_makes_the_run_incorrect(workload, fault, monkeypatch):
    if fault in ("token", "exchange"):
        # the fault patches the program's module; undo it after the test
        from lrzip_next_tpu_torch.models import pipeline
        from lrzip_next_tpu_torch.ops import matcher
        monkeypatch.setattr(pipeline, "split_long_runs",
                            pipeline.split_long_runs)
        monkeypatch.setattr(matcher, "split_stage", matcher.split_stage)
    out, lines = run(small_cell(workload, monkeypatch), fault)
    assert out["correct"] is False, lines


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [None, "control"])
def test_the_control_fails_on_the_card(cuda, fault, monkeypatch):
    c = small_cell("rans-L7.vm-1gib", monkeypatch, device="cuda")
    out, lines = run(c, fault, device="cuda")
    assert out["correct"] is (fault is None), lines
