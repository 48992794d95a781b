"""A later cell, configuration, traffic mix, generator and metric come
as new files and new entries of ``BENCHMARK.json``: the harness finds
them by name, and no file it already has changes."""

import hashlib
import json
import shutil
import time
from pathlib import Path

import pytest

from portbench.core import cell as cells, runner

ROOT = Path(__file__).resolve().parents[2]

GENERATOR = '''"""A dummy generator: a byte pattern shifted by the index."""

import numpy as np


def warmup(params):
    return [-1]


def generate(params, seed, index, device, with_info=False):
    base = np.arange(params["size"], dtype=np.int64) * 7 + seed + index
    return (base % 251).astype(np.uint8)
'''

READER = '''"""dummy.files: the number of compresses in the window."""


def read(run):
    return float(sum(o["kind"] == "compress" for o in run.ops))
'''


def digests(root: Path) -> dict:
    files = [root / "BENCHMARK.json"] + sorted(
        p for p in (root / "portbench").rglob("*")
        if p.is_file() and "__pycache__" not in p.parts)
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in files}


def test_a_new_cell_and_metric_from_new_files_only(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(tmp_path)

    pb = tmp_path / "portbench"
    (pb / "corpus" / "dummy_pattern.py").write_text(GENERATOR)
    (pb / "traffic" / "dummy-mix.json").write_text(json.dumps({
        "generator": "dummy_pattern", "ops": ["compress", "decompress"],
        "nominal_file_seconds": 0.05,
        "reference_sample": {"files": 1, "chunks_per_file": 1},
        "params": {"size": 1 << 16}}))
    (pb / "configs" / "dummy-none.json").write_text(json.dumps({
        "name": "dummy-none", "settings": {"method": "none"}}))
    (pb / "metrics" / "dummy.files.py").write_text(READER)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "dummy-none", "source": "https://example.org/dummy",
        "file": "portbench/configs/dummy-none.json", "reduced": [],
        "why": "a test"})
    bench["workloads"].append({
        "name": "dummy-none.dummy-mix", "config": "dummy-none",
        "traffic": "dummy-mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({
        "name": "dummy.files", "unit": "files", "better": "higher",
        "source": "host_clock", "layer": "harness", "moves": "ratio",
        "workloads": ["dummy-none.dummy-mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    after = digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before \
        | {"BENCHMARK.json": after["BENCHMARK.json"]}
    assert set(after) - set(before) == {
        "portbench/corpus/dummy_pattern.py",
        "portbench/traffic/dummy-mix.json",
        "portbench/configs/dummy-none.json",
        "portbench/metrics/dummy.files.py"}

    c = cells.resolve("dummy-none.dummy-mix", tmp_path)
    assert c.generator.__file__ == str(pb / "corpus" / "dummy_pattern.py")
    assert [m.name for m in c.per_layer] == ["dummy.files"]
    assert {m.name for m in c.end_to_end} >= {"compress_MBps", "ratio",
                                              "setup_s"}
    for trace, names in ((False, {"compress_MBps", "ratio", "setup_s"}),
                         (True, {"dummy.files"})):
        out = runner.run_cell(c, 5, 0.05, trace, time.perf_counter(),
                              device="cpu", log=lambda m: None,
                              report=lambda m: None)
        assert out["correct"] and names <= set(out["metrics"])
    assert out["metrics"]["dummy.files"]["value"] >= 1
    # the cells already there resolve as before, from the same tree
    for w in bench["workloads"][:-1]:
        assert cells.resolve(w["name"], tmp_path).name == w["name"]


def test_a_mix_takes_another_mixs_content_by_name(tmp_path):
    shutil.copytree(ROOT / "portbench" / "traffic",
                    tmp_path / "portbench" / "traffic")
    mixes = tmp_path / "portbench" / "traffic"
    (mixes / "vm-1gib-compress.json").write_text(json.dumps({
        "params_from": "vm-1gib", "ops": ["compress"],
        "nominal_file_seconds": 5.0}))
    base = cells.load_traffic(tmp_path, "vm-1gib")
    mix = cells.load_traffic(tmp_path, "vm-1gib-compress")
    assert mix["params"] == base["params"]
    assert mix["generator"] == base["generator"] == "vm_image"
    assert mix["ops"] == ["compress"] and mix["nominal_file_seconds"] == 5.0
    assert "params_from" not in mix
    (mixes / "bad.json").write_text(json.dumps({
        "params_from": "vm-1gib", "params": {"size": 1}}))
    with pytest.raises(ValueError):
        cells.load_traffic(tmp_path, "bad")
