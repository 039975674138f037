"""The readings that the limits of a cell's check are set from.

    python3 -m portbench.calibrate --workload <name> --seeds <n> [<n> ...] [--controls]

For each seed, in one process: the inputs, the program's set-up without
its warm-up (train: its checked steps; render: a short window over the
checked poses), the reference, and the check's numbers of the program
against it (the lower readings). With `--controls` also those of
  * the control: the reference computed with TF32 on, in the program's place;
  * train: the fault "half of the batch left out, the mean taken over the
    rest" (the reference with the loss over the first half of the pixel
    rows), and "a step that returns its state unchanged" (the inputs' own
    parameters and a zero first gradient);
  * render: the fault "an answer altered where it is produced" (the
    program's frames with their two middle pixel rows swapped).
One JSON line a seed on standard output. The benchmark's own runs never
run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import registry
from .run import make_drive, make_inputs, reference_numbers
from . import check

RENDER_WINDOW_S = 2.0          # covers the checked poses at the cell's own load


def swap_rows(frames: dict) -> dict:
    """Each frame with its two middle pixel rows swapped."""
    def swap(x):
        y, m = x.clone(), x.shape[-2] // 2
        y[..., [m - 1, m], :] = x[..., [m, m - 1], :]
        return y
    return {i: (swap(c), swap(d)) for i, (c, d) in frames.items()}


def zeros(tree):
    if isinstance(tree, dict):
        return {k: zeros(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def unchanged(inputs) -> dict:
    """The results of steps that return their state unchanged."""
    return {"params": inputs.params, "first_grad": zeros(inputs.params)}


def leaves(cell, got: dict, want: dict, start: dict) -> dict:
    """Per leaf of a train cell: the first gradient's and the change's
    norms, the program's and the reference's; and each step's losses."""
    from .reference.optim import tree_leaves

    def names(tree, pre=""):
        if isinstance(tree, dict):
            return [n for k in tree for n in names(tree[k], f"{pre}{k}.")]
        return [pre[:-1]]

    norm = lambda t: [float(x.double().norm()) for x in tree_leaves(t)]
    delta = lambda p: {k: check._diff(p[k], start[k]) for k in start}
    rows = zip(names(start), norm(got["first_grad"]), norm(want["first_grad"]),
               norm(delta(got["params"])), norm(delta(want["params"])))
    return {"losses": [got["losses"].tolist(), want["losses"].tolist()],
            "leaves": {n: [g, gw, d, dw] for n, g, gw, d, dw in rows}}


def readings(cell, seed: int, dev: torch.device, controls: bool,
             detail: bool = False) -> dict:
    # set-up's warm-up of the loop runs after the checked steps, and the
    # window renders the same frames without it: the readings do not
    # depend on it
    cell = cell._replace(traffic=dict(cell.traffic, warm_iterations=0, warm_frames=0))
    inputs = make_inputs(cell, seed, dev)
    drive, poses, stages = make_drive(cell, seed, inputs, dev)
    if cell.traffic["kind"] == "render":
        drive.window(RENDER_WINDOW_S)
    got = drive.program_results()
    del drive
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed}
    out["program"], want = reference_numbers(cell, inputs, got, poses, stages=stages)
    if detail and cell.traffic["kind"] == "train":
        out["detail"] = leaves(cell, got, want, inputs.params)
    if not controls:
        return out
    if cell.traffic["kind"] == "train":
        tf32 = check.reference_train(cell, inputs, got["frames"], tf32=True)
        out["tf32"] = check.train_numbers(tf32, want, inputs.params)
        half = check.reference_train(cell, inputs, got["frames"],
                                     rows=cell.config["sensor"]["H"] // 2)
        out["half_batch"] = check.train_numbers(half, want, inputs.params)
        out["unchanged"] = check.train_numbers(dict(unchanged(inputs), losses=want["losses"]),
                                               want, inputs.params)
    else:
        far, atol = cell.config["raster"]["far"], cell.limits["far_atol"]
        tf32 = check.reference_render(cell, inputs, poses, tf32=True, stages=stages)
        out["tf32"] = check.render_numbers(tf32["frames"], want["frames"], far, atol)
        out["altered"] = check.render_numbers(swap_rows(got["frames"]), want["frames"], far,
                                              atol)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", action="store_true")
    p.add_argument("--detail", action="store_true",
                   help="train cells: each leaf's norms and each step's losses")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = registry.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(cell, seed, dev, args.controls, args.detail)
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
