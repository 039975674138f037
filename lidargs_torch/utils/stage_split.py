"""Where the render and the train step spend their time on the card, stage
by stage.

Counterpart of the JAX round's `tools/stage_split.py`, with its flags and
defaults, plus `--device` (default `cuda`; `--device cpu` runs every
program once as a rehearsal and measures nothing).

Each row is a cumulative prefix of the production pipeline
(`utils/prefixes.py`), captured once as a CUDA graph (`train/graphs.py`
`StaticProgram`: the port's counterpart of one jitted program) and
replayed, so the difference between consecutive rows is the later stage's
cost inside the whole, without the host launches that an eager prefix
would time. The rows:

  * `full_frame`: the render (`render_field`), always;
  * `--prefix`: the six prefixes prefilter, decode, project+pack, cull
    sort, bin sort, gather; the full frame closes them with the composite;
  * `--grad-prefix`: the backward of the float prefixes and of the full
    frame (each delta is a stage's forward and backward together);
  * `--train`: the render, `frame_loss`, `loss_and_grads`, and
    `train_step` without and with the densification statistics.

All rows are timed in turns: after 3 warm-up replays each, `--n` rounds
replay every row once between two CUDA events, in order on even rounds and
reversed on odd ones, so that drift falls on all rows alike; each row's
median is reported, and deltas as measured (a negative delta is noise and
is shown as such). Beside each row: device ms and device launches from
torch.profiler over 3 replays (`profiling.profile`), and the launches of
the port's kernels (`KERNELS`) that a replay makes, by the launcher's count
(`utils/cuda_build.py` `launches`, counted at capture) and, for K1-K8, by
name among the trace's device rows.

Without a mode flag the stages run standalone instead, eagerly, each timed
alone with CUDA events: those times include each stage's own host launches
and never sum to the frame (the reason the prefixes exist).

    python -m lidargs_torch.utils.stage_split --tile_h 4 --tile_capacity 768 \\
        --max_tiles_per_gaussian 8 --prefix --grad-prefix --train [--json out.json]

`--json` writes `{row: median ms}` under the JAX round's key names, with
`card` (nvidia-smi's name and power limit), `device_ms`, `device_launches`,
`trace_complete`, `kernel_launches` and `traced_kernels` keyed by row;
`utils/roofline.py --stage-split` reads it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys

import numpy as np
import torch

from ..config import ModelConfig, OptConfig, RasterConfig
from ..lidar.beams import uniform_beam_inclinations
from ..lidar.frames import LidarFrame
from ..models.field import (AnchorField, decode_visible, prefilter_anchors, project_decoded,
                            render_fn)
from ..ops.projection import PackedCols, pack_splats
from ..ops.rasterize import bin_instances_windows, gather_instances, render_packed_window
from ..train.graphs import StaticProgram
from ..train.trainer import init_train_state
from . import cuda_build, profiling
from .device import resolve_device
from .prefixes import bins, cull, grad_prefixes, stage_prefixes, train_rows
from .testing import shell_field

H = 64
WARMUP = 3                    # calls before a standalone stage's timed calls
NOT_MEASURED = "not measured"
# the port's kernels: each short name and the symbol that `cuda_build.launch`
# counts its launches under
KERNELS = {"K1": "lidargs_composite_fwd", "K2": "lidargs_composite_bwd",
           "K3": "lidargs_composite_fwd_windows", "K4": "lidargs_composite_bwd_windows",
           "K5": "lidargs_surfel_fwd", "K6": "lidargs_surfel_bwd",
           "K7": "lidargs_surfel_fwd_windows", "K8": "lidargs_surfel_bwd_windows",
           "F1": "lidargs_front_fwd", "F2": "lidargs_surfel_front_fwd",
           "N1": "lidargs_knn_chamfer",
           "N2": "lidargs_knn_gram_topk", "N3": "lidargs_knn3_direct"}
# the name of each composite kernel's template among a trace's device rows
# (K3/K4 and K7/K8 are the window instances of K1/K2 and K5/K6)
TRACE_NAMES = dict(zip(("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8"),
                       profiling.PORT_KERNELS[:2] * 2 + profiling.PORT_KERNELS[2:] * 2))


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def raster_config(args) -> RasterConfig:
    """The JAX round's split configuration from the flags."""
    return RasterConfig(
        max_visible=2 ** 17, max_tiles_per_gaussian=args.max_tiles_per_gaussian,
        tile_capacity=args.tile_capacity or 384 * args.tile_h, chunk=16, tile_h=args.tile_h,
        fused_gather=args.fused, instance_capacity=args.instance_capacity)


def scene(anchors: int, anchor_capacity: int, W: int, device):
    """The JAX round's split scene: `anchors` shell anchors (`shell_field`,
    seed 0) at `anchor_capacity`, one 64 x W frame at the origin with a
    zero ground truth. Returns (mcfg, params, valid, frame)."""
    mcfg = ModelConfig(anchor_capacity=anchor_capacity)
    params, valid = shell_field(mcfg, anchors, seed=0, device=device)
    beams = uniform_beam_inclinations(2.4, 20.9, H)
    frame = LidarFrame.from_lidar2world(np.eye(4), beams, np.zeros((3, H, W), np.float32),
                                        uid=0, device=device)
    return mcfg, params, valid, frame


def split_rows(params, valid, frame, bg, mcfg: ModelConfig, rcfg: RasterConfig, modes,
               ocfg: OptConfig | None = None, state=None, variant: str = "beam") -> dict:
    """{row key: compute()} for the modes ("prefix", "grad-prefix",
    "train"), under the JAX round's key names, the full frame first. The
    train rows start from `state` (default: `init_train_state` of the
    field) under `ocfg` (default `OptConfig()`). The prefixes are the beam
    variant's."""
    render = render_fn(variant)
    rows = {"full_frame": torch.no_grad()(
        lambda: render(params, valid, frame, mcfg, rcfg, bg)[0])}
    if variant != "beam" and {"prefix", "grad-prefix"} & set(modes):
        raise ValueError("the prefixes are the beam variant's")
    if "prefix" in modes:
        for name, fn in stage_prefixes(mcfg, rcfg):
            rows[f"prefix {name}"] = torch.no_grad()(lambda fn=fn: fn(params, valid, frame))
    if "grad-prefix" in modes:
        for name, fn in grad_prefixes(mcfg, rcfg, bg):
            rows[f"grad-prefix {name}"] = lambda fn=fn: fn(params, valid, frame)
    if "train" in modes:
        if state is None:
            state = init_train_state(AnchorField(params=params, valid=valid, voxel_size=0.35),
                                     mcfg)
        for name, fn in train_rows(mcfg, rcfg, ocfg or OptConfig(), bg, variant):
            rows[f"train {name}"] = lambda fn=fn: fn(state, frame)
    return rows


def reached(key: str, variant: str = "beam") -> tuple:
    """The port's kernels that the row `key` must launch: the forward
    composite where it renders, the backward where it differentiates the
    render."""
    fwd, bwd = {"beam": ("K1", "K2"), "surfel": ("K5", "K6")}[variant]
    if key in ("grad-prefix composite (full)", "train fwd + loss + grad",
               "train full step (no stats)", "train full step (stats)"):
        return fwd, bwd
    if key in ("full_frame", "train render fwd", "train fwd + loss"):
        return (fwd,)
    return ()


@contextlib.contextmanager
def counting():
    """A dict that the block's end fills with the launches of each of
    KERNELS that the block counted (`cuda_build.launches`' change)."""
    before, n = cuda_build.launches.copy(), {}
    yield n
    n.update((k, cuda_build.launches[s] - before[s]) for k, s in KERNELS.items())


def kernel_launches(run) -> dict:
    """The launches of each of KERNELS that one `run()` counts."""
    with counting() as n:
        run()
    return n


def measure(rows: dict, device, n: int):
    """Capture each row as a StaticProgram in one graph pool and measure it:
    (result, {key: program}). The result holds, by row key, `stage_ms`
    (median of `n` rounds in turns, `profiling.time_in_turns`), `ms_min`,
    `ms_max`, `device_ms`, `device_launches`, `trace_complete`,
    `trace_uneven` and `traced_kernels` (the port's kernels among the
    trace's device rows, a replay) from `profiling.profile` over 3 replays,
    and `kernel_launches` (the launches of one run; a program counts at
    capture what each replay launches). On the CPU every time is "not
    measured" and each row runs once."""
    dev = torch.device(device)
    pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None
    programs = {k: StaticProgram(fn, lambda out: out, dev, pool) for k, fn in rows.items()}
    res = {"kernel_launches": {k: kernel_launches(p.run) for k, p in programs.items()}}
    if dev.type != "cuda":
        nm = {k: NOT_MEASURED for k in rows}
        res.update(stage_ms=nm, ms_min=nm, ms_max=nm, device_ms=nm, device_launches=nm,
                   trace_complete={k: False for k in rows}, traced_kernels=nm)
        return res, programs
    ms = profiling.time_in_turns({k: p.run for k, p in programs.items()}, n)
    prof = {k: profiling.profile(p.run) for k, p in programs.items()}
    res.update(stage_ms={k: float(np.median(v)) for k, v in ms.items()},
               ms_min={k: min(v) for k, v in ms.items()},
               ms_max={k: max(v) for k, v in ms.items()},
               device_ms={k: p["device_ms_per_frame"] for k, p in prof.items()},
               device_launches={k: p["device_launches_per_frame"] for k, p in prof.items()},
               trace_complete={k: p["complete"] for k, p in prof.items()},
               trace_uneven={k: p["uneven"] for k, p in prof.items() if "uneven" in p},
               traced_kernels={k: p["port_kernels"] for k, p in prof.items()})
    return res, programs


def standalone(params, valid, frame, mcfg: ModelConfig, rcfg: RasterConfig, device,
               n: int) -> dict:
    """The stages one by one, eagerly, each timed alone (CUDA events over `n`
    calls after 3): {JAX round's stage key: ms} ("not measured" on the CPU).
    The cull includes its pack; the last row is bin + gather + composite."""
    C = mcfg.color_channel
    dev = torch.device(device)

    def timed(fn):
        out = fn()
        if dev.type != "cuda":
            return NOT_MEASURED, out
        return float(np.mean(profiling.event_ms(fn, n, WARMUP))), out

    def project_and_pack(ng):
        splats = project_decoded(ng, frame, rcfg)
        return splats, pack_splats(splats)

    ms = {}
    with torch.no_grad():
        ms["prefilter"], av = timed(lambda: prefilter_anchors(params, valid, frame, rcfg))
        ms["mlp decode"], ng = timed(
            lambda: decode_visible(params, valid, av, frame, mcfg, rcfg)[0])
        ms["projection"], (splats, _) = timed(lambda: project_and_pack(ng))
        ms["cull"], pkv = timed(lambda: cull(splats, rcfg))
        if rcfg.fused_gather:
            gy, gx = rcfg.grid_shape(H, frame.W)
            ms["instance emission"], (gid, _, _, _) = timed(lambda: bin_instances_windows(
                pkv[:, PackedCols.rect(C)].to(torch.int32), pkv[:, PackedCols.center(C)],
                pkv[:, PackedCols.validf(C)] > 0.0, rcfg, gx, gy))
            ms["instance gather"], _ = timed(lambda: pkv[gid.clamp(0, pkv.shape[0] - 1)])
        else:
            ms["instance emission"], (ids, _, _) = timed(lambda: bins(pkv, frame, rcfg, C))
            ms["instance gather"], _ = timed(lambda: gather_instances(pkv, ids))
        ms["pallas composite"], _ = timed(
            lambda: render_packed_window(pkv, frame.beams, frame.W, rcfg, C))
    return ms


def _fmt(x, w=8, p=3) -> str:
    return f"{x:{w}.{p}f}" if isinstance(x, (int, float)) else f"{x:>{w}s}"


def print_rows(res: dict, keys, label) -> None:
    """Each row's median ms, its delta over the row before, device ms,
    device launches and kernel launches."""
    prev = 0.0
    for k in keys:
        t = res["stage_ms"][k]
        delta = t - prev if isinstance(t, float) and isinstance(prev, float) else NOT_MEASURED
        launched = {n: c for n, c in res["kernel_launches"][k].items() if c}
        lost = (" (the trace lost records)" if isinstance(res["device_ms"][k], float)
                and not res["trace_complete"][k] else "")
        print(f"{label(k):34s}: {_fmt(t)} ms (+{_fmt(delta)})  device {_fmt(res['device_ms'][k])}"
              f" ms, {_fmt(res['device_launches'][k], 7, 1)} launches{lost}  kernels {launched}")
        prev = t


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tile_h", type=int, default=1)
    ap.add_argument("--tile_capacity", type=int, default=0, help="0 = 384 * tile_h")
    ap.add_argument("--max_tiles_per_gaussian", type=int, default=16)
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--instance_capacity", type=int, default=0)
    ap.add_argument("--anchors", type=int, default=60_000)
    ap.add_argument("--anchor_capacity", type=int, default=65_536)
    ap.add_argument("--W", type=int, default=2650)
    ap.add_argument("--n", type=int, default=20, help="timing rounds")
    ap.add_argument("--json", default=None,
                    help="also write {row: ms} json (utils/roofline.py --stage-split input)")
    ap.add_argument("--prefix", action="store_true",
                    help="cumulative prefixes: each stage's cost inside the whole frame")
    ap.add_argument("--train", action="store_true",
                    help="the train step: fwd+loss, +grad, +adam, +stats")
    ap.add_argument("--grad-prefix", action="store_true",
                    help="the backward of each prefix: deltas = a stage's forward and backward")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default); cpu rehearses every row once and measures nothing")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    mcfg, params, valid, frame = scene(args.anchors, args.anchor_capacity, args.W, dev)
    rcfg = raster_config(args)
    bg = torch.zeros(2, device=dev)
    card_csv = card() if dev.type == "cuda" else "cpu rehearsal: nothing measured"
    print(f"# {card_csv}; torch {torch.__version__}; 64x{args.W}, {args.anchors} anchors, "
          f"h{rcfg.tile_h}/K{rcfg.tile_capacity}/cap{rcfg.max_tiles_per_gaussian}"
          f"{' fused' if rcfg.fused_gather else ''}; CUDA graphs, {args.n} rounds in turns")
    modes = [m for m in ("prefix", "grad-prefix", "train") if getattr(args, m.replace("-", "_"))]
    res, programs = measure(split_rows(params, valid, frame, bg, mcfg, rcfg, modes), dev, args.n)
    del programs
    keys = list(res["stage_ms"])
    print_rows(res, ["full_frame"], lambda k: "FULL frame")
    prefix = [k for k in keys if k.startswith("prefix ")]
    if prefix:
        print_rows(res, prefix + ["full_frame"],
                   lambda k: "upto composite (full)" if k == "full_frame" else f"upto {k[7:]}")
    for head, label in (("grad-prefix ", "grad upto "), ("train ", "")):
        group = [k for k in keys if k.startswith(head)]
        if group:
            print_rows(res, group, lambda k: label + k[len(head):])
    out = {**res["stage_ms"], "card": card_csv,
           **{k: res[k] for k in ("device_ms", "device_launches", "trace_complete",
                                  "kernel_launches", "traced_kernels")}}
    if not modes:
        eager = standalone(params, valid, frame, mcfg, rcfg, dev, args.n)
        for k, v in eager.items():
            print(f"{k + ' (eager, alone)':34s}: {_fmt(v)} ms")
        out.update(eager)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"stage json -> {args.json}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
