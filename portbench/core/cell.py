"""Resolve a workload of ``BENCHMARK.json`` into what a run needs.

Everything that belongs to one configuration, traffic mix, corpus
generator or metric lives in a file of its own, found by name:

- the configuration: the ``file`` its entry in ``configs`` names;
- the traffic mix: ``portbench/traffic/<traffic>.json``, whose
  ``generator`` names ``portbench/corpus/<generator>.py``; a mix that
  names another in ``params_from`` runs that mix's generator on its
  ``params``, the same content, with its own keys (``ops``, ...) over
  the rest;
- each metric: ``portbench/metrics/<name>.py``, whose ``read(run)``
  returns the value, or None where the run has nothing to read.

A cell's metrics are the entries of ``end_to_end`` and ``per_layer``
whose ``workloads`` list names it, or that have no such list.  A later
cell, configuration or metric is new files and new entries; no file
here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable, List

HERE = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: Callable


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    generator: object
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_file(path: Path, name: str):
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _metrics(entries, workload: str, root: Path) -> List[Metric]:
    out = []
    for e in entries:
        if "workloads" in e and workload not in e["workloads"]:
            continue
        reader = load_file(root / "portbench" / "metrics" / f"{e['name']}.py",
                           "portbench_metric_" + e["name"].replace(".", "_")
                           .replace("-", "_"))
        out.append(Metric(e["name"], e["unit"], reader.read))
    return out


def load_traffic(root: Path, name: str) -> dict:
    traffic = json.loads((root / "portbench" / "traffic" /
                          f"{name}.json").read_text())
    base = traffic.pop("params_from", None)
    if base is None:
        return traffic
    if "params" in traffic or "generator" in traffic:
        raise ValueError(f"traffic {name!r} takes its content from "
                         f"{base!r}, so it names no params or generator")
    content = load_traffic(root, base)
    return {**content, **traffic, "params": content["params"]}


def load_generator(root: Path, name: str):
    importlib.import_module("portbench.corpus")
    return load_file(root / "portbench" / "corpus" / f"{name}.py",
                     f"portbench.corpus.{name}")


def resolve(workload: str, root: Path = HERE.parent) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    w = _named(bench["workloads"], workload, "workload")
    c = _named(bench["configs"], w["config"], "configuration")
    config = json.loads((root / c["file"]).read_text())
    traffic = load_traffic(root, w["traffic"])
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic,
                generator=load_generator(root, traffic["generator"]),
                end_to_end=_metrics(bench["end_to_end"], workload, root),
                per_layer=_metrics(bench["per_layer"], workload, root))
