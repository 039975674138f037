"""Finds a cell's parts by the names in `BENCHMARK.json`.

A workload names a configuration and a traffic mix. The configuration's
file is the one `BENCHMARK.json` gives it; the traffic mix is
`traffic/<traffic>.json`; the limits of the cell's check are
`limits/<workload>.json`; each metric, end-to-end or per-layer, is read by
`metrics/<metric>.py`, a module with `read(record) -> float | None`. A
later change adds a cell, a mix or a metric as new files and entries; no
file here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict               # the configuration's file
    traffic: dict              # traffic/<traffic>.json
    limits: dict               # limits/<workload>.json
    end_to_end: list           # BENCHMARK.json's metric entries that this cell reports
    per_layer: list


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(work)}")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = root / HERE.name
    return Cell(
        name=name, chips=w["chips"],
        config=json.loads((root / cfg["file"]).read_text()),
        traffic=json.loads((here / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((here / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)])


def reader(metric: str, root: Path = ROOT) -> Callable:
    """`read` of `metrics/<metric>.py`."""
    path = root / HERE.name / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
