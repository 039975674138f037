"""The readings that the limits of a refined re-simulation cell are set
from: `calibrate.py`'s, and two faults planted in the port's timed path.

    python3 -m portbench.refiner_faults --workload <name> --seeds <n> [<n> ...]

For each seed, in one process: the inputs, the program's set-up without
its warm-up and a short window over the checked poses, the reference, and
the check's numbers against it of
  * `program`: the port as it is (the lower readings);
  * `tf32`: the control, the reference computed with TF32 on in the
    program's place;
  * `altered`: the program's frames with their two middle pixel rows
    swapped (`calibrate.swap_rows`);
  * `skipped`: the port's frames without the refiner, the field's render
    alone;
  * `no_attn_residual`: the port's UNet with its attention block's
    residual dropped (`proj(h)` where the block adds `x + proj(h)`).
One JSON line a seed on standard output. The benchmark's own runs never
run this.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

import torch

from . import check, registry
from .calibrate import RENDER_WINDOW_S, swap_rows
from .run import make_drive, make_inputs

FAULTS = ("skipped", "no_attn_residual")


@contextlib.contextmanager
def planted(fault):
    """The port with `fault` planted while the block runs (None: as it is).
    `skipped` is planted by the drive (`program_frames`)."""
    if fault != "no_attn_residual":
        yield
        return
    from lidargs_torch.models import raydrop

    forward = raydrop.AttnBlock.forward
    raydrop.AttnBlock.forward = lambda self, x: forward(self, x) - x
    try:
        yield
    finally:
        raydrop.AttnBlock.forward = forward


def program_frames(cell, seed: int, inputs, dev: torch.device, fault=None,
                   seconds: float = RENDER_WINDOW_S):
    """(the program's results, {index: Pose} of the checked poses, the
    drawn stages) of a render cell's set-up without its warm-up and a
    window of `seconds`, with `fault` planted; `skipped` drives the port
    without the cell's stages, and the stages returned are drawn all the
    same, for the reference."""
    cell = cell._replace(traffic=dict(cell.traffic, warm_frames=0))
    stages = [(s, s.draw(cell, seed, dev)) for s in cell.stages]
    with planted(fault):
        drive, poses, _ = make_drive(cell._replace(stages=()) if fault == "skipped" else cell,
                                     seed, inputs, dev)
        drive.window(seconds)
    got = drive.program_results()
    del drive
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return got, poses, stages


def readings(cell, seed: int, dev: torch.device, seconds: float = RENDER_WINDOW_S) -> dict:
    inputs = make_inputs(cell, seed, dev)
    got, poses, stages = program_frames(cell, seed, inputs, dev, seconds=seconds)
    faulty = {f: program_frames(cell, seed, inputs, dev, f, seconds)[0] for f in FAULTS}
    far, atol = cell.config["raster"]["far"], cell.limits["far_atol"]
    want = check.reference_render(cell, inputs, poses, stages=stages)["frames"]
    tf32 = check.reference_render(cell, inputs, poses, tf32=True, stages=stages)["frames"]
    numbers = lambda frames: check.render_numbers(frames, want, far, atol)  # noqa: E731
    out = {"seed": seed, "program": numbers(got["frames"]), "tf32": numbers(tf32),
           "altered": numbers(swap_rows(got["frames"]))}
    out.update({f: numbers(r["frames"]) for f, r in faulty.items()})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("portbench.refiner_faults")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.refiner_faults: no CUDA device", file=sys.stderr)
        return 2
    cell = registry.load_cell(args.workload)
    if cell.traffic["kind"] != "render" or not cell.stages:
        print(f"portbench.refiner_faults: {cell.name} is no refined render cell",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(cell, seed, dev)
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
