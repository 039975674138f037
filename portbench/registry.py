"""Finds a cell's parts by the names in `BENCHMARK.json`.

A workload names a configuration and a traffic mix. The configuration's
file is the one `BENCHMARK.json` gives it; the traffic mix is
`traffic/<traffic>.json`; the limits of the cell's check are
`limits/<workload>.json`; each metric, end-to-end or per-layer, is read by
`metrics/<metric>.py`, a module with `read(record) -> float | None`; each
name in the configuration file's top-level `"stages"` list is a stage of
the program's frame, `stages/<name>.py`. A later change adds a cell, a
mix, a metric or a stage as new files and entries; no file here names one.

A stage module provides:
  * `KINDS`: the traffic kinds it applies to; a cell of another kind is
    refused at load. Only "render": the training check does not apply a
    stage's reference yet.
  * `draw(cell, seed, dev)`: the stage's own inputs (a refiner's weights),
    drawn from the run's seed, once a process in set-up (`run.make_drive`).
  * `program(drawn) -> dict`: keyword arguments of the port's `Trainer`,
    given by the drives. This is all the port learns of the stage: its
    timed work runs inside the port's own path, never in the harness. The
    reference reads `drawn` as drawn, so hand the port copies of what it
    may write.
  * `reference(drawn, color, depth) -> (color, depth)`: plain PyTorch,
    importing nothing of the port or of JAX; `check.reference_render`
    applies it to each reference frame after the field's render, under
    the same precision (TF32 off; on in the control).
  * `work(drawn, H, W) -> (ops, bytes)`: a frame's FP32 operations and
    bytes for the stage. The operations are added to those `mfu.*`
    divides (`counts.step_ops`); both are in the record's `work`
    (`counts.Work.stages`) and the result's `work["stage:<name>"]`.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
STAGE_KINDS = ("render",)      # the kinds whose check applies a stage's reference
STAGE_PARTS = ("KINDS", "draw", "program", "reference", "work")


class Stage(NamedTuple):
    """A stage of the program's frame, `stages/<name>.py` (see above)."""

    name: str
    kinds: tuple
    draw: Callable
    program: Callable
    reference: Callable
    work: Callable


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict               # the configuration's file
    traffic: dict              # traffic/<traffic>.json
    limits: dict               # limits/<workload>.json
    end_to_end: list           # BENCHMARK.json's metric entries that this cell reports
    per_layer: list
    stages: tuple = ()         # a Stage for each name in the configuration's "stages"


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_stage(name: str, cell: str, kind: str, root: Path = ROOT) -> Stage:
    """The stage `name` of the cell `cell`, whose traffic is of `kind`."""
    path = root / HERE.name / "stages" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"cell {cell!r} names the stage {name!r}: no file {path}")
    mod = _module(path, f"portbench_stage_{name}")
    missing = [p for p in STAGE_PARTS if not hasattr(mod, p)]
    if missing:
        raise AttributeError(f"stage {name!r} ({path}) lacks {missing}")
    kinds = tuple(mod.KINDS)
    if kind not in kinds:
        raise ValueError(f"stage {name!r} applies to {list(kinds)} traffic; cell {cell!r} is "
                         f"{kind!r} traffic")
    if set(kinds) - set(STAGE_KINDS):
        raise ValueError(f"stage {name!r} applies to {list(kinds)}; the check applies a "
                         f"stage's reference only to {list(STAGE_KINDS)} traffic")
    return Stage(name, kinds, mod.draw, mod.program, mod.reference, mod.work)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(work)}")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = root / HERE.name
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=name, chips=w["chips"], config=config, traffic=traffic,
        limits=json.loads((here / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
        stages=tuple(load_stage(s, name, traffic["kind"], root)
                     for s in config.get("stages", [])))


def reader(metric: str, root: Path = ROOT) -> Callable:
    """`read` of `metrics/<metric>.py`."""
    return _module(root / HERE.name / "metrics" / f"{metric}.py",
                   f"portbench_metric_{metric}").read
