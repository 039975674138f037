"""A/B of the composite kernels built from several source trees, on one card.

    python -m lidargs_torch.utils.kernel_ab OUT_DIR LABEL=CSRC_DIR [LABEL=CSRC_DIR ...]

For each `csrc` directory it builds the sources of `KERNELS` that the tree
has (K1 `composite_fwd.cu`, K2 `composite_bwd.cu`, K5 `surfel_fwd.cu`, K6
`surfel_bwd.cu`) with the package's nvcc flags (all trees at once), writes
each library's SASS and resource usage (`cuobjdump -sass -res-usage`) to
OUT_DIR/<label>.<kernel>.sass and reads the registers and spill bytes of
each template instance from the nvcc log. Then it times every build's
kernels in turns on the same inputs (4 turns of 50 launches after 5 warm-up
launches, CUDA events, the order reversed every other turn), and compares
each build's output with that of the first build that has the kernel: bit
for bit and, for a backward kernel, each gradient column scaled by its
largest magnitude against `BWD_TOL` (the bounds `chip_smoke.py` holds K2 and
K6 to against their plain versions). The inputs are frame 0 of
`chip_smoke.py`'s full-width scene (64x2650, 60,000 shell anchors, k=6) at
the beam render tiling (h4/K768/cap8) for K1/K2 and at the surfel CLI
tiling (h1/K384/cap32) for K5/K6; a backward kernel takes the first build's
forward output as `res` and a cotangent drawn from a seed on every row the
forward writes. Prints one JSON line with the card's name and power limit.

It judges the bits: it exits non-zero, after the JSON line, when any
build's output, forward or backward, differs from the first build's by a
single bit. The column-scaled comparison is reported beside, for a
redesign that sums a backward row's pixels in another order.

Compare two versions of the repository by unpacking one (`git archive`)
into a git-ignored directory and naming both `csrc` directories.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

H, W = 64, 2650                 # the scene of chip_smoke.py
N_ANCHORS = 60_000
MODEL = dict(anchor_capacity=65_536)
RASTER = dict(tile_h=4, tile_capacity=768, max_tiles_per_gaussian=8, max_visible=2 ** 18)
SURFEL_RASTER = dict(tile_h=1, tile_capacity=384, max_tiles_per_gaussian=32,
                     max_visible=2 ** 18)
TURNS, ITERS, WARMUP = 4, 50, 5
# source -> (launch function, tensor pointers, float constants); each source
# of a variant `v` is `v_fwd` or `v_bwd`
KERNELS = {"composite_fwd": ("lidargs_composite_fwd", 4, 3),
           "composite_bwd": ("lidargs_composite_bwd", 6, 3),
           "surfel_fwd": ("lidargs_surfel_fwd", 4, 8),
           "surfel_bwd": ("lidargs_surfel_bwd", 6, 8)}
BWD_TOL = {"mean": 1e-5, "atol": 2e-5, "far_count": 64, "max": 1e-3}
_RESOURCES = re.compile(r"Function properties for \S*?_kernel(I\w*?E)EEv\S*\s+(\d+) bytes stack "
                        r"frame, (\d+) bytes spill stores, (\d+) bytes spill loads\s+ptxas "
                        r"info\s*: Used (\d+) registers")


def _time_ms(fn, iters: int, warmup: int) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    ev[0].record()
    for i in range(iters):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return float(np.median([ev[i].elapsed_time(ev[i + 1]) for i in range(iters)]))


def _bind(lib: Path, name: str):
    symbol, n_ptr, n_float = KERNELS[name]
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P] * n_ptr + [I] * 5 + [Fl] * n_float + [P]
    fn.restype = I
    return fn


def resources(log: str) -> dict:
    """{template arguments ("C,windows[,max threads,min blocks]"):
    [registers, spill store bytes, spill load bytes]} of every kernel
    instance in an nvcc `-Xptxas -v` log."""
    return {",".join(re.findall(r"L[ib](\d+)E", m[0])): [int(m[4]), int(m[2]), int(m[3])]
            for m in _RESOURCES.findall(log)}


def column_scaled(got, want, nv: int) -> dict:
    """A backward kernel's dinst against another's: each of the first `nv`
    columns scaled by its largest magnitude in `want`; the columns after
    must be zero in both."""
    scale = want[..., :nv].flatten(0, -2).abs().amax(dim=0).clamp_min(1e-30)
    d = (got[..., :nv] - want[..., :nv]).abs() / scale
    err = {"mean": float(d.mean()), "max": float(d.max()),
           "far_count": int((d > BWD_TOL["atol"]).sum()),
           "tail_zero": bool((got[..., nv:] == 0).all() and (want[..., nv:] == 0).all())}
    err["within_tol"] = (err["tail_zero"] and err["mean"] <= BWD_TOL["mean"]
                         and err["far_count"] <= BWD_TOL["far_count"]
                         and err["max"] <= BWD_TOL["max"])
    return err


def _inputs(dev) -> dict:
    """{variant: (inst, counts, pix, C, float constants, output rows, rows
    the forward writes, gradient columns)} for frame 0 of the scene."""
    import torch

    from ..config import ModelConfig, RasterConfig
    from ..lidar import LidarFrame, uniform_beam_inclinations
    from ..models.field import field_splats, field_surfels
    from ..ops import composite_kernel as ck
    from ..ops import surfel_kernel as sk
    from ..ops.rasterize import cull_sorted_rows, tile_inputs
    from ..ops.surfel import cull_sorted_surfels, surfel_tile_inputs
    from .testing import sensor_poses, shell_field

    mcfg = ModelConfig(**MODEL)
    C = mcfg.color_channel
    params, valid = shell_field(mcfg, N_ANCHORS, seed=0, device=dev)
    beams = uniform_beam_inclinations(2.4, 20.9, H)
    frame = LidarFrame.from_lidar2world(sensor_poses(1, seed=1)[0], beams,
                                        np.zeros((3, H, W), np.float32), device=dev)
    with torch.no_grad():
        rcfg = RasterConfig(**RASTER)
        pkv, _ = cull_sorted_rows(field_splats(params, valid, frame, mcfg, rcfg)[0], rcfg)
        beam = tile_inputs(pkv, frame.beams, W, rcfg, C)[:3]
        scfg = RasterConfig(**SURFEL_RASTER)
        pkv, _ = cull_sorted_surfels(field_surfels(params, valid, frame, mcfg, scfg)[0], scfg, C)
        surfel = surfel_tile_inputs(pkv, frame.beams, W, scfg, C)[:3]
    return {"composite": (*beam, C, ck._consts(rcfg), ck.OUT_ROWS, C + 2, 14 + C),
            "surfel": (*surfel, C, sk._consts(scfg), sk.OUT_ROWS, C + 9, 16 + C)}


def judge(outs: dict, nvs: dict) -> tuple[dict, list]:
    """Each build's output against the first build's of the same kernel.
    `outs` maps (label, kernel) to an output, in build order; `nvs` maps a
    backward kernel to its gradient columns. Returns ({"label.kernel":
    comparison}, [the "label.kernel"s whose output is not the first build's
    bit for bit]); a backward kernel's comparison adds `column_scaled`."""
    import torch

    first, same, failed = {}, {}, []
    for (lab, name), o in outs.items():
        ref = first.setdefault(name, o)
        key = f"{lab}.{name}"
        same[key] = {"bit_equal": bool(torch.equal(o, ref)),
                     "max_abs_diff": float((o - ref).abs().max())}
        if name in nvs:
            same[key]["column_scaled"] = column_scaled(o, ref, nvs[name])
        if not same[key]["bit_equal"]:
            failed.append(key)
    return same, failed


def main(argv) -> None:
    import torch

    from . import cuda_build

    if len(argv) < 2 or not all("=" in a for a in argv[1:]):
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: needs a CUDA device")
    out_dir = Path(argv[0])
    out_dir.mkdir(parents=True, exist_ok=True)
    trees = {a.split("=", 1)[0]: Path(a.split("=", 1)[1]).resolve() for a in argv[1:]}
    wanted = {lab: [n for n in KERNELS if (d / f"{n}.cu").exists()] for lab, d in trees.items()}
    with concurrent.futures.ThreadPoolExecutor(len(trees)) as ex:
        futs = {lab: ex.submit(cuda_build.build, wanted[lab], trees[lab]) for lab in trees}
        libs = {lab: f.result() for lab, f in futs.items()}
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res_usage = {}
    for lab, built in libs.items():
        for name, lib in built.items():
            sass = subprocess.run([cuobjdump, "-sass", "-res-usage", str(lib)],
                                  capture_output=True, text=True, check=True, timeout=120)
            (out_dir / f"{lab}.{name}.sass").write_text(sass.stdout)
            res_usage[f"{lab}.{name}"] = resources(lib.with_suffix(".log").read_text())

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(0)
    calls, outs, nvs, shapes = {}, {}, {}, {}
    for variant, (inst, counts, pix, C, consts, out_rows, written, nv) in _inputs(dev).items():
        T, K, F = inst.shape
        npix = pix.shape[2]
        shapes[variant] = {"inst": [T, K, F], "npix": npix}
        scal = (T, K, F, npix, C, *consts, stream)
        g = torch.randn((T, out_rows, npix), generator=gen, device=dev)
        g[:, written:] = 0.0
        fname, bname = f"{variant}_fwd", f"{variant}_bwd"
        nvs[bname] = nv
        res = None
        for lab, built in libs.items():
            if fname not in built:
                continue
            fwd = _bind(built[fname], fname)
            o = torch.empty((T, out_rows, npix), device=dev)
            ptrs = [x.data_ptr() for x in (inst, counts, pix, o)]
            calls[(lab, fname)] = lambda fwd=fwd, ptrs=ptrs, scal=scal: fwd(*ptrs, *scal)
            outs[(lab, fname)] = o
            if res is None:
                if calls[(lab, fname)]() != 0:
                    sys.exit(f"kernel_ab: {lab}.{fname} failed to launch")
                res = o.clone()
            if bname in built:
                bwd = _bind(built[bname], bname)
                d = torch.empty_like(inst)
                ptrs = [x.data_ptr() for x in (inst, counts, pix, res, g, d)]
                calls[(lab, bname)] = lambda bwd=bwd, ptrs=ptrs, scal=scal: bwd(*ptrs, *scal)
                outs[(lab, bname)] = d
    for key, fn in calls.items():
        if fn() != 0:
            sys.exit(f"kernel_ab: {key} failed to launch")
    torch.cuda.synchronize()

    ms = {f"{lab}.{name}": [] for lab, name in calls}
    order = list(calls)
    for turn in range(TURNS):
        for lab, name in (order if turn % 2 == 0 else order[::-1]):
            ms[f"{lab}.{name}"].append(_time_ms(calls[(lab, name)], ITERS, WARMUP))
    same, failed = judge(outs, nvs)
    card = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "inputs": shapes, "ms_median_per_turn": ms,
                      "vs_first_build": same, "failed": failed,
                      "registers_spill_stores_loads": res_usage}))
    if failed:
        sys.exit(f"kernel_ab: outputs differ from the first build's: {', '.join(failed)}")


if __name__ == "__main__":
    main(sys.argv[1:])
