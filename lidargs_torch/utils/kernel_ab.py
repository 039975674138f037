"""A/B of the hand-written kernels built from several source trees, on one card.

    python -m lidargs_torch.utils.kernel_ab OUT_DIR [SOURCE ...] LABEL=CSRC_DIR [LABEL=CSRC_DIR ...]

For each `csrc` directory it builds the sources of `KERNELS` that the tree
has (K1 `composite_fwd.cu`, K2 `composite_bwd.cu`, K5 `surfel_fwd.cu`, K6
`surfel_bwd.cu`, N1 and N2 `knn.cu`), or only the SOURCEs named, with the
package's nvcc flags (all trees at once), writes each library's SASS and
resource usage (`cuobjdump -sass -res-usage`) to OUT_DIR/<label>.<source>.sass
and reads the registers and spill bytes of each kernel instance from the
nvcc log. Then it times every build's kernels in turns on the same inputs
(4 turns of 50 launches after 5 warm-up launches, 10 after 2 for N1 and N2,
CUDA events, the order reversed every other turn), and compares each
build's output with that of the first build that has the kernel: bit for
bit and, for a backward kernel, each gradient column scaled by its largest
magnitude against `BWD_TOL` (the bounds `chip_smoke.py` holds K2 and K6 to
against their plain versions).

The composite inputs are frame 0 of `chip_smoke.py`'s full-width scene
(64x2650, 60,000 shell anchors, k=6) at the beam render tiling
(h4/K768/cap8) for K1/K2 and at the surfel CLI tiling (h1/K384/cap32) for
K5/K6; a backward kernel takes the first build's forward output as `res`
and a cotangent drawn from a seed on every row the forward writes. The
distance inputs are the procedural street of `chip_smoke.py`'s CLI phases
(`make_street_dataset`, seed 0, 50 frames of 64x2650, written under
OUT_DIR and deleted after): N1 from test frame 0's points to test frame 1's
(~160k a side, every row valid), N2 the 4 smallest on the 500k init cloud.
A tree whose `knn.cu` takes the packed point set runs N1 and N2 under the
package's launch plan (`ops/knn_kernel.py` `launch_plan`), the packing in
the timed call, and with each cluster size of `KNN_CLUSTERS`; a tree of
the first design (point rows and norms, one row a thread) is bound by
`KNN_ROWS`. Prints one JSON line with the card's name and power limit.

It judges the bits: it exits non-zero, after the JSON line, when any
build's output (any plan's) differs from the first build's by a single
bit. The column-scaled comparison is reported beside, for a redesign that
sums a backward row's pixels in another order.

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
KNN_ITERS, KNN_WARMUP = 10, 2
STREET = dict(n_frames=50, H=64, W=2650, seed=0)   # chip_smoke.py's CLI_SCENE
KNN_K = 4                       # N2's k: the 3-NN scales' 3 and the query itself
# source -> its launch functions, each (name, tensor pointers, ints, float
# constants); each composite source of a variant `v` is `v_fwd` or `v_bwd`
KERNELS = {"composite_fwd": (("lidargs_composite_fwd", 4, 5, 3),),
           "composite_bwd": (("lidargs_composite_bwd", 6, 5, 3),),
           "surfel_fwd": (("lidargs_surfel_fwd", 4, 5, 8),),
           "surfel_bwd": (("lidargs_surfel_bwd", 6, 5, 8),),
           "knn": (("lidargs_knn_chamfer", 5, 5, 0), ("lidargs_knn_gram_topk", 4, 6, 0))}
# the first design's knn interface: the point rows and their norms
KNN_ROWS = (("lidargs_knn_chamfer", 6, 2, 0), ("lidargs_knn_gram_topk", 5, 3, 0))
# cluster sizes timed beside the package's plan (labels label@s<S>)
KNN_CLUSTERS = (1, 2, 4, 8)
BWD_TOL = {"mean": 1e-5, "atol": 2e-5, "far_count": 64, "max": 1e-3}
_RESOURCES = re.compile(r"Function properties for \S*?_kernel(I\w*?E)EEv\S*\s+(\d+) bytes stack "
                        r"frame, (\d+) bytes spill stores, (\d+) bytes spill loads\s+ptxas "
                        r"info\s*: Used (\d+) registers")
_PLAIN_RESOURCES = re.compile(r"Function properties for (\S+)\s+(\d+) bytes stack frame, (\d+) "
                              r"bytes spill stores, (\d+) bytes spill loads\s+ptxas info\s*: "
                              r"Used (\d+) registers")


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


def _bind(lib: Path, signature: tuple):
    """The launch function `signature` = (name, tensor pointers, ints, float
    constants) of `lib`, with its arguments declared (the stream last)."""
    symbol, n_ptr, n_int, n_float = signature
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P] * n_ptr + [I] * n_int + [Fl] * n_float + [P]
    fn.restype = I
    return fn


def resources(log: str) -> dict:
    """{template arguments ("C,windows[,max threads,min blocks]"; N1/N2
    "K,R,chamfer"), or a kernel's name where it is no template:
    [registers, spill store bytes, spill load bytes]} of every kernel
    instance in an nvcc `-Xptxas -v` log."""
    out = {",".join(re.findall(r"L[ib](\d+)E", m[0])): [int(m[4]), int(m[2]), int(m[3])]
           for m in _RESOURCES.findall(log)}
    for sym, _, st, ld, regs in _PLAIN_RESOURCES.findall(log):
        name = _plain_kernel_name(sym)
        if name:
            out[name] = [int(regs), int(st), int(ld)]
    return out


def _plain_kernel_name(sym: str) -> str | None:
    """The name `*_kernel` of a kernel that is no template, from its mangled
    symbol (a length prefix, the name, then the parameters after E)."""
    for m in re.finditer(r"\d+", sym):
        for cut in range(len(m.group())):       # the length may be a suffix of the digits
            n, start = int(m.group()[cut:]), m.end()
            name = sym[start:start + n]
            if name.endswith("_kernel") and sym[start + n:start + n + 1] == "E":
                return name
    return None


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


def knn_interface(knn_cu: Path) -> tuple:
    """The launch functions of a tree's `knn.cu`: `KERNELS["knn"]` where N1
    takes the packed point set, else the first design's `KNN_ROWS`."""
    m = re.search(r"\bint lidargs_knn_chamfer\(([^)]*)\)", knn_cu.read_text())
    return KERNELS["knn"] if m and "packed" in m.group(1) else KNN_ROWS


def knn_plan(n_q: int, n_p: int, n_sm: int, blocks_per_sm: int, kk, cluster=None):
    """The package's launch plan of N1 (`kk` None) or N2, with its cluster
    size replaced where `cluster` is given."""
    from ..ops import knn_kernel as nk

    plan = nk.launch_plan(n_q, n_p, n_sm, blocks_per_sm, kk)
    if cluster is None:
        return plan
    groups = -(-n_p // nk.GROUP)
    s = max(1, min(cluster, groups))
    return nk.LaunchPlan(plan.rows_per_thread, s, plan.row_blocks, nk.GROUP * -(-groups // s))


def _blocks_per_sm(lib: Path, kk) -> int:
    """The blocks of N1 (`kk` None) / N2 that one SM holds, from the
    library's own occupancy query."""
    from ..ops import knn_kernel as nk

    fn = ctypes.CDLL(str(lib)).lidargs_knn_blocks_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    if fn(0 if kk is None else kk, nk.rows_per_thread(kk), ctypes.byref(n)) != 0:
        sys.exit(f"kernel_ab: the occupancy query of {lib} failed")
    return n.value


def _knn_inputs(dev, work: Path) -> dict:
    """N1's clouds (test frames 0 and 1 of the street, each frame's GT
    points as the evaluation builds them) and N2's 500k init cloud."""
    from ..data.synthetic import make_street_dataset
    from ..data.waymo import read_lidar_scene
    from ..lidar.pano import pano_to_lidar

    make_street_dataset(str(work), **STREET)
    try:
        scene = read_lidar_scene(str(work), num_frames=STREET["n_frames"], device=dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def cloud(frame):
        gt = frame.gt_image
        return pano_to_lidar(gt[2] * gt[0], scene.beam_inclinations).float().contiguous()

    return {"a": cloud(scene.test_frames[0]), "b": cloud(scene.test_frames[1]),
            "init": scene.init_points.contiguous()}


def _knn_calls(libs: dict, trees: dict, dev, stream, work: Path) -> tuple[dict, dict, dict]:
    """({(label, kernel): launch}, {(label, kernel): output}, {inputs and
    plans}) of N1 and N2 for every tree that has `knn.cu`; a tree of the
    packed interface under the package's plan (label) and with each cluster
    size of `KNN_CLUSTERS` (label@s<S>), the packing inside the launch. The street is
    written under `work` and deleted."""
    import dataclasses

    import torch

    from ..ops import knn_kernel as nk

    x = _knn_inputs(dev, work)
    a, b, init = x["a"], x["b"], x["init"]
    a2, b2, p2 = ((t * t).sum(-1) for t in (a, b, init))
    av, bv = (torch.ones(t.shape[0], dtype=torch.bool, device=dev) for t in (a, b))
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    # (kernel, query tensors, points, their norms, their mask, kk, output shape)
    work = (("knn_chamfer", (a, a2, av), b, b2, bv, None, (a.shape[0],)),
            ("knn_gram_topk", (init, p2), init, p2, None, KNN_K, (init.shape[0], KNN_K)))
    info = {"knn_chamfer": {"queries": a.shape[0], "points": b.shape[0],
                            "pairs": a.shape[0] * b.shape[0]},
            "knn_gram_topk": {"queries": init.shape[0], "points": init.shape[0], "k": KNN_K,
                              "pairs": init.shape[0] ** 2}, "plans": {}}
    calls, outs = {}, {}
    ptr = lambda ts: [t.data_ptr() for t in ts]
    # the closures hold the tensors (a pointer alone would let the caching
    # allocator hand the memory to the packing of another call)
    for lab, built in libs.items():
        if "knn" not in built:
            continue
        sig = knn_interface(trees[lab] / "knn.cu")
        fns = [_bind(built["knn"], s) for s in sig]
        for fn, (name, q, p, pn, pv, kk, shape) in zip(fns, work):
            if sig is KNN_ROWS:
                o = torch.empty(shape, device=dev)
                ts = (*q, p, pn, o)
                ints = (q[0].shape[0], p.shape[0], *(() if kk is None else (kk,)))
                calls[(lab, name)] = lambda fn=fn, ts=ts, ints=ints: fn(*ptr(ts), *ints, stream)
                outs[(lab, name)] = o
                continue
            bps = _blocks_per_sm(built["knn"], kk)
            for cluster in (None, *KNN_CLUSTERS):
                key = (lab if cluster is None else f"{lab}@s{cluster}", name)
                plan = knn_plan(q[0].shape[0], p.shape[0], n_sm, bps, kk, cluster)
                info["plans"][f"{key[0]}.{name}"] = {**dataclasses.asdict(plan),
                                                     "blocks_per_sm": bps}
                o = torch.empty(shape, device=dev)
                ints = (q[0].shape[0], plan.slice_rows, *(() if kk is None else (kk,)),
                        plan.rows_per_thread, plan.row_blocks, plan.cluster)

                def call(fn=fn, q=q, o=o, ints=ints, p=p, pv=pv, plan=plan):
                    packed = nk.pack_points(p, plan, pv)
                    return fn(*ptr(q), packed.data_ptr(), o.data_ptr(), *ints, stream)

                calls[key] = call
                outs[key] = o
    return calls, outs, info


def _composite_calls(libs: dict, dev, stream, keep: list) -> tuple[dict, dict, dict, dict]:
    """({(label, kernel): launch}, {(label, kernel): output}, {backward
    kernel: gradient columns}, {variant: input shapes}) of K1/K2 and K5/K6
    for every tree that has their sources. The launches take raw pointers:
    `keep` holds their tensors for as long as the caller keeps it."""
    import torch

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
            fwd = _bind(built[fname], KERNELS[fname][0])
            o = torch.empty((T, out_rows, npix), device=dev)
            keep.append((inst, counts, pix, o))
            ptrs = [x.data_ptr() for x in (inst, counts, pix, o)]
            calls[(lab, fname)] = lambda fwd=fwd, ptrs=ptrs, scal=scal: fwd(*ptrs, *scal)
            outs[(lab, fname)] = o
            if res is None:
                if calls[(lab, fname)]() != 0:
                    sys.exit(f"kernel_ab: {lab}.{fname} failed to launch")
                res = o.clone()
            if bname in built:
                bwd = _bind(built[bname], KERNELS[bname][0])
                d = torch.empty_like(inst)
                keep.append((res, g, d))
                ptrs = [x.data_ptr() for x in (inst, counts, pix, res, g, d)]
                calls[(lab, bname)] = lambda bwd=bwd, ptrs=ptrs, scal=scal: bwd(*ptrs, *scal)
                outs[(lab, bname)] = d
    return calls, outs, nvs, shapes


def main(argv) -> None:
    import torch

    from . import cuda_build

    labelled = [a for a in argv[1:] if "=" in a]
    sources = [a for a in argv[1:] if "=" not in a]
    if len(argv) < 2 or not labelled or any(s not in KERNELS for s in sources):
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: needs a CUDA device")
    out_dir = Path(argv[0])
    out_dir.mkdir(parents=True, exist_ok=True)
    trees = {a.split("=", 1)[0]: Path(a.split("=", 1)[1]).resolve() for a in labelled}
    names = sources or list(KERNELS)
    wanted = {lab: [n for n in names if (d / f"{n}.cu").exists()] for lab, d in trees.items()}
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
    calls, outs, nvs, shapes, keep = {}, {}, {}, {}, []
    if any(n in built for built in libs.values() for n in KERNELS if n != "knn"):
        calls, outs, nvs, shapes = _composite_calls(libs, dev, stream, keep)
    if any("knn" in built for built in libs.values()):
        k_calls, k_outs, shapes["knn"] = _knn_calls(libs, trees, dev, stream,
                                                       out_dir / "street")
        calls.update(k_calls)
        outs.update(k_outs)
    for key, fn in calls.items():
        if fn() != 0:
            sys.exit(f"kernel_ab: {key} failed to launch")
    torch.cuda.synchronize()

    ms = {f"{lab}.{name}": [] for lab, name in calls}
    order = list(calls)
    for turn in range(TURNS):
        for lab, name in (order if turn % 2 == 0 else order[::-1]):
            iters = (KNN_ITERS, KNN_WARMUP) if name.startswith("knn") else (ITERS, WARMUP)
            ms[f"{lab}.{name}"].append(_time_ms(calls[(lab, name)], *iters))
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
