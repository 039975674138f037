"""One run of one cell: set-up, the measured window, the check, the result.

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the scene and the field from the seed on the card, builds the
port's trainer and drives it until every shape the window uses is
captured. The window then runs for `--seconds` (train: iterations until a
loss read finds the time up; render: frames until the time is up). With
`--trace 1` the profiler covers a fixed segment of the window, and after
it the prefix rows are timed; the run reports the per-layer metrics
instead of the end-to-end ones. After the window the program is freed and
the reference checks what the program produced (`check.py`). The numbers
compared, each beside its limit, are the last lines on standard error and
the last key of the result, which is the last line on standard output.

The run refuses (exit 2, no result) without a card, or with fewer cards
than the cell asks for, and fails (exit 3, no result) if the process has
loaded JAX or the JAX package by the end.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import NamedTuple, Optional

import torch

from . import check, registry, rows
from .drive import RenderDrive, TrainDrive, checked_poses
from .scene import make_field, make_scene, novel_poses
from .tracing import TOP, Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "lidargs_tpu")
HOST_THREADS = 2               # PyTorch's host threads: the loop's host work is one thread's


class Inputs(NamedTuple):
    scene: object
    params: dict
    valid: torch.Tensor
    voxel: float


def loaded_forbidden() -> list:
    """Top-level names of `sys.modules` that are JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def make_inputs(cell, seed: int, dev: torch.device) -> Inputs:
    scene = make_scene(cell.traffic["scene"]["world_seed"], cell.config["sensor"],
                       cell.traffic["scene"], dev)
    params, valid, voxel = make_field(cell.config["field"]["field_seed"], cell.config["model"],
                                      scene.init_points, cell.config["field"])
    return Inputs(scene, params, valid, voxel)


def make_drive(cell, seed: int, inputs: Inputs, dev: torch.device):
    """(the drive, {index: Pose} of the checked poses or None for train,
    [(registry.Stage, drawn)] of the cell's stages, drawn here once)."""
    t = cell.traffic
    stages = [(s, s.draw(cell, seed, dev)) for s in cell.stages]
    if t["kind"] == "train":
        return TrainDrive(cell, seed, inputs, dev, stages), None, stages
    poses = novel_poses(seed, t["scene"], t, dev)
    checked = checked_poses(seed, len(poses), t["checked_frames"])
    return (RenderDrive(cell, seed, inputs, dev, poses, checked, stages),
            {i: poses[i] for i in checked}, stages)


def reference_numbers(cell, inputs: Inputs, got: dict, poses: Optional[dict],
                      tf32: bool = False, rows_kept: Optional[int] = None, stages=()):
    """(numbers, reference results) of the program's results `got`."""
    if cell.traffic["kind"] == "train":
        want = check.reference_train(cell, inputs, got["frames"], tf32, rows_kept)
        return check.train_numbers(got, want, inputs.params), want
    want = check.reference_render(cell, inputs, poses, tf32, stages)
    return check.render_numbers(got["frames"], want["frames"], cell.config["raster"]["far"],
                                cell.limits["far_atol"]), want


def prefix_rows(cell, drive, dev: torch.device) -> dict:
    """{row: ms} of the prefix rows on the program's state at the window's
    end and the first frame drawn after the checked steps (train) or the
    trajectory's first pose (render)."""
    if cell.traffic["kind"] == "train":
        state = drive.state
        frame = drive.frames[drive.drawn[cell.traffic["checked_steps"]]]
    else:
        state = SimpleNamespace(params=drive.params, valid=drive.valid)
        frame = drive.frames[0]
    fns = rows.row_functions(state, frame, drive.mcfg, drive.rcfg, drive.ocfg,
                             drive.trainer.bg, cell.config["variant"],
                             cell.traffic["kind"] == "train")
    return rows.measure(fns, dev) if fns else {}


def run_cell(cell, seed: int, seconds: float, trace: bool, dev: torch.device,
             t_start: float) -> dict:
    """One run: the result's keys, and the record the readers read."""
    t = cell.traffic
    inputs = make_inputs(cell, seed, dev)
    drive, poses, stages = make_drive(cell, seed, inputs, dev)
    setup_s = time.perf_counter() - t_start
    tracer = Tracer(t["trace_start"], t["traced"], drive.spans, dev) if trace else None
    drive.window(seconds, tracer)
    if tracer is not None:
        tracer.stop(drive.iterations)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    row_ms = prefix_rows(cell, drive, dev) if trace else {}
    got = drive.program_results()
    counted = (drive.counted_inputs(t["counted_frames"])
               if trace and t["kind"] == "train" else None)
    rec = SimpleNamespace(
        cell=cell.name, kind=t["kind"], variant=cell.config["variant"],
        model=cell.config["model"], setup_s=setup_s, window_s=drive.window_s,
        iterations=drive.iterations, latency_ms=list(getattr(drive, "latency_ms", [])),
        densify_s=list(getattr(drive, "densify_s", [])), failed=drive.failed,
        trace=tracer.summary if tracer is not None else None, rows=row_ms,
        anchors_end=getattr(drive, "anchors_end", None))
    del drive
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers, want = reference_numbers(cell, inputs, got, poses, stages=stages)
    # the counts of the work a traced step or frame did: render, the
    # reference's checked frames (drawn over the whole trajectory, which
    # the traced segment renders once); train, the reference on the field
    # and frames of the traced segment
    if not trace:
        rec.work = []
    elif t["kind"] == "render":
        rec.work = want["work"]
    else:
        rec.work = check.reference_work(cell, inputs.scene, *counted) if counted else []
    correct = check.judge(numbers, cell.limits["limits"]) and rec.failed == 0 and all(
        math.isfinite(v) for v in numbers.values())
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = registry.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": cell.chips, "memory_peak_bytes": peak}
    if dev.type == "cuda":
        device["power_limit"] = power_limit()
    result = {"correct": bool(correct), "attempted": rec.iterations, "failed": rec.failed,
              "metrics": metrics, "device": device}
    if rec.trace is not None:
        device["busy_s"], device["window_s"] = rec.trace.busy_s, rec.trace.window_s
        ops = sorted(rec.trace.seconds_by_name.items(), key=lambda kv: -kv[1])[:TOP]
        result["breakdown"] = {"device_ops": [[n[:120], s] for n, s in ops],
                               "idle_gaps": [[n[:120], s] for n, s in rec.trace.gaps]}
    # the counts the per-layer metrics read (means over the counted frames)
    if rec.work:
        result["work"] = {k: statistics.mean(getattr(w, k) for w in rec.work)
                          for k in ("visible_anchors", "kept", "live_params")}
        result["work"]["composite_ops"] = statistics.mean(
            w.composite_fwd.ops + (w.composite_bwd.ops if t["kind"] == "train" else 0)
            for w in rec.work)
        for name, _ in rec.work[0].stages:
            result["work"][f"stage:{name}"] = {
                k: statistics.mean(getattr(dict(w.stages)[name], k) for w in rec.work)
                for k in ("ops", "bytes")}
    if rec.anchors_end is not None:
        result.setdefault("work", {})["anchors_end"] = rec.anchors_end
    result["check"] = {k: {"value": v, "limit": cell.limits["limits"][k]}
                       for k, v in numbers.items()}
    return result


def parse(argv):
    p = argparse.ArgumentParser("portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def emit(result: dict, out=sys.stdout, err=sys.stderr) -> int:
    """Print the compared numbers beside their limits, then the result;
    0, or 3 without a result if JAX or the JAX package is loaded."""
    found = loaded_forbidden()
    if found:
        print(f"portbench: the process loaded {found}; no result", file=err)
        return 3
    for k, v in result["check"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})", file=err)
    print(f"check correct = {result['correct']}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0


def main(argv, t_start: float) -> int:
    args = parse(argv)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; no result", file=sys.stderr)
        return 2
    cell = registry.load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found; no result", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.set_num_threads(HOST_THREADS)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev, t_start)
    return emit(result)
