"""A/B of the composite kernels built from several source trees, on one card.

    python -m lidargs_torch.utils.kernel_ab OUT_DIR LABEL=CSRC_DIR [LABEL=CSRC_DIR ...]

For each `csrc` directory it builds `composite_fwd.cu` (K1) and, where the
tree has it, `composite_bwd.cu` (K2) with the package's nvcc flags (all trees
at once), and writes each library's SASS and resource usage (`cuobjdump
-sass -res-usage`) to OUT_DIR/<label>.<kernel>.sass. Then it times every
build's kernels in turns on the same inputs (4 turns of 50 launches after 5
warm-up launches, CUDA events, the order reversed every other turn), and
compares each build's output bit for bit with that of the first build that
has the kernel. The inputs are frame 0 of `chip_smoke.py`'s full-width scene
(64x2650, 60,000 shell anchors, k=6, the CLI's render tiling); K2 takes K1's
output as `res` and a cotangent drawn from a seed. Prints one JSON line
with the card's name and power limit.

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
TURNS, ITERS, WARMUP = 4, 50, 5
KERNELS = {"composite_fwd": ("lidargs_composite_fwd", 4),
           "composite_bwd": ("lidargs_composite_bwd", 6)}


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
    symbol, n_ptr = KERNELS[name]
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P] * n_ptr + [I, I, I, I, I, Fl, Fl, Fl, P]
    fn.restype = I
    return fn


def _inputs(dev):
    import torch

    from ..config import ModelConfig, RasterConfig
    from ..lidar import LidarFrame, uniform_beam_inclinations
    from ..models.field import field_splats
    from ..ops.rasterize import cull_sorted_rows, tile_inputs
    from .testing import sensor_poses, shell_field

    mcfg, rcfg = ModelConfig(**MODEL), RasterConfig(**RASTER)
    params, valid = shell_field(mcfg, N_ANCHORS, seed=0, device=dev)
    beams = uniform_beam_inclinations(2.4, 20.9, H)
    frame = LidarFrame.from_lidar2world(sensor_poses(1, seed=1)[0], beams,
                                        np.zeros((3, H, W), np.float32), device=dev)
    with torch.no_grad():
        splats = field_splats(params, valid, frame, mcfg, rcfg)[0]
        pkv, _ = cull_sorted_rows(splats, rcfg)
        inst, counts, pix, _ = tile_inputs(pkv, frame.beams, W, rcfg, mcfg.color_channel)
    return inst, counts, pix, mcfg.color_channel, rcfg


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
    regs = {}
    for lab, built in libs.items():
        for name, lib in built.items():
            sass = subprocess.run([cuobjdump, "-sass", "-res-usage", str(lib)],
                                  capture_output=True, text=True, check=True, timeout=120)
            (out_dir / f"{lab}.{name}.sass").write_text(sass.stdout)
            log = lib.with_suffix(".log").read_text()
            regs[f"{lab}.{name}"] = re.findall(r"Used (\d+) registers", log)

    dev = torch.device("cuda", 0)
    inst, counts, pix, C, rcfg = _inputs(dev)
    T, K, F = inst.shape
    npix = pix.shape[2]
    gen = torch.Generator(device=dev).manual_seed(0)
    g = torch.randn(pix.shape, generator=gen, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scal = (T, K, F, npix, C, rcfg.alpha_min, rcfg.alpha_clamp, rcfg.transmittance_min, stream)
    res = None
    outs, calls = {}, {}
    for lab, built in libs.items():
        fwd = _bind(built["composite_fwd"], "composite_fwd")
        o = torch.empty(pix.shape, device=dev)
        calls[(lab, "composite_fwd")] = (
            lambda fwd=fwd, o=o: fwd(inst.data_ptr(), counts.data_ptr(), pix.data_ptr(),
                                     o.data_ptr(), *scal))
        outs[(lab, "composite_fwd")] = o
        if res is None:
            calls[(lab, "composite_fwd")]()
            res = o.clone()
        if "composite_bwd" in built:
            bwd = _bind(built["composite_bwd"], "composite_bwd")
            d = torch.empty_like(inst)
            calls[(lab, "composite_bwd")] = (
                lambda bwd=bwd, d=d: bwd(inst.data_ptr(), counts.data_ptr(), pix.data_ptr(),
                                         res.data_ptr(), g.data_ptr(), d.data_ptr(), *scal))
            outs[(lab, "composite_bwd")] = d
    for key, fn in calls.items():
        if fn() != 0:
            sys.exit(f"kernel_ab: {key} failed to launch")
    torch.cuda.synchronize()

    ms = {f"{lab}.{name}": [] for lab, name in calls}
    order = list(calls)
    for turn in range(TURNS):
        for lab, name in (order if turn % 2 == 0 else order[::-1]):
            ms[f"{lab}.{name}"].append(_time_ms(calls[(lab, name)], ITERS, WARMUP))
    first = {}
    same = {}
    for (lab, name), o in outs.items():
        ref = first.setdefault(name, o)
        same[f"{lab}.{name}"] = {"bit_equal": bool(torch.equal(o, ref)),
                                 "max_abs_diff": float((o - ref).abs().max())}
    card = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "inputs": {"inst": [T, K, F], "npix": npix},
                      "ms_median_per_turn": ms, "vs_first_build": same,
                      "registers_per_template": regs}))


if __name__ == "__main__":
    main(sys.argv[1:])
