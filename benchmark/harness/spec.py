"""What a run is made of, found by name: ``BENCHMARK.json`` at the root of
the checkout, ``configs/<name>.json`` (through the config entry's
``file``), ``traffic/<mix>.json``, ``metrics/<metric>.py`` and
``checks/<stage>.py`` (the reference stage a mix's ``check.reference``
names).  Adding a configuration, a mix, a cell, a per-layer metric or a
reference stage adds files and entries and edits none."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_benchmark(path: str | None = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


@dataclass
class Cell:
    """One workload entry with its configuration and traffic files read."""

    name: str
    chips: int
    config: dict  # the configuration file
    traffic: dict  # traffic/<mix>.json
    end_to_end: list  # the end-to-end metric entries this cell reports
    per_layer: list  # the per-layer metric entries this cell reports


def path_in_checkout(rel: str) -> str:
    return rel if os.path.isabs(rel) else os.path.join(ROOT, rel)


def load_traffic(name: str) -> dict:
    with open(os.path.join(BENCH_DIR, "traffic", f"{name}.json"), encoding="utf-8") as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names: set | None = None) -> bool:
    """Whether ``cell`` reports ``metric``: named in its ``workloads``, or,
    without the key, every cell (an end-to-end metric) or every cell that
    reports the end-to-end metric it moves (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or load_benchmark()
    w = _by_name(bench["workloads"], name, "workload")
    cfg_entry = _by_name(bench["configs"], w["config"], "config")
    with open(path_in_checkout(cfg_entry["file"]), encoding="utf-8") as f:
        config = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=load_traffic(w["traffic"]), end_to_end=e2e, per_layer=per_layer)


def _load(kind: str, name: str):
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``read(rec) -> float | None`` of ``metrics/<name>.py``."""
    return _load("metrics", name).read


def stage(name: str):
    """The reference stage ``checks/<name>.py``: the module with its
    ``LIMITS``, its hooks into the session (``draw``, ``before``, ``after``,
    ``at_end``), its ``problems`` and ``readings``, and ``TINY_TRAFFIC``
    (README.md, "A reference stage")."""
    return _load("checks", name)
