#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`lidargs_torch`).

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from `lidargs_torch/csrc/` (nvcc,
sm_90a, one process per source, all at once, into `build/lidargs_torch/`),
then:

  1. renders the full-width benchmark scene (64x2650 range view, 60,000
     anchors on a synthetic street shell, k=6 -> 393,216 gaussians, random
     heads from a seed) from N_FRAMES sensor poses through `measure_fps`,
     with the launch counts set to 0 just before and read just after, and
     requires one K1 launch per frame, finite outputs and occupancy > 0;
  2. re-renders one frame through `run_eval` against a ground truth made
     from its first render (the render is deterministic, so the metrics
     must be exact);
  3. holds the tiled render (K1) against the O(P*HW) golden renderer
     (plain PyTorch) on a small scene;
  4. holds K1 against its plain PyTorch version on the inputs that the main
     path gave it for one frame;
  5. times the render, K1 and the plain version with CUDA events, and
     computes K1's bound from this run's inputs;
  6. lists the render's costliest device kernels from torch.profiler;
  7. trains: N_STEPS `Trainer.step`s of the same scene against random GT
     images (as the JAX package's train-step benchmark draws them) from
     sensor poses, with the counts set to 0 just before and read just after,
     requiring one K1 and one K2 launch per step, finite losses and
     parameters that changed, and statistics that accumulate; then one
     `Trainer.densify`, whose anchor count must be the count before plus
     grown minus pruned;
  8. holds K2 against its plain PyTorch version on the inputs one step gave
     it, and the parameter gradients of one step through K1/K2 against
     those through the plain versions, and reports the difference between
     two identical steps (PyTorch does not promise that the `[T, K, F]`
     gather's backward, an accumulating index_put, is deterministic on CUDA);
  9. times the train step, K2 and the plain backward with CUDA events,
     computes K2's bound from this run's inputs, and profiles a few steps.

It prints a timing line, a `kernels` line, the card's name and power limit
(`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`) and, as
the last line, `{"ok": true, "device": {...}}`. Any failure exits non-zero
before that line; without a CUDA device it exits non-zero at once.

Tolerances, kernel against plain PyTorch on identical inputs: the kernels
multiply the transmittance in sequence where the plain versions take a
chunked cumprod, so a pixel whose T*(1-alpha) sits at the 1e-4 threshold can
stop one instance earlier or later.
  * K1: features and final T: mean |d| <= 1e-5, max |d| <= 2e-2; depth
    (metres): mean |d| <= 1e-3, max |d| <= 2.0.
  * K2: each dinst column scaled by its largest magnitude: mean |d| <= 1e-5,
    at most 64 elements beyond 2e-5 (the 16 columns of four rows whose
    instance sits at a flipped pixel), max <= 1e-3. On the smoke scene the
    H100 read a mean of 3.9e-9, a max of 8.2e-7 and no element beyond 2e-5
    over 183,125 touched rows: the max allows ~1000 times that, and a flip
    whose pixel carries more than 0.1% of its column's largest gradient
    fails.
  * Gradients of one step, kernels against plain versions, per parameter
    leaf: |g_k - g_p| / |g_p| <= 1e-2 and cosine >= 0.999.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

H, W = 64, 2650
N_ANCHORS = 60_000
MODEL = dict(anchor_capacity=65_536)              # feat 32, k=6, hidden 32, C=2
RASTER = dict(tile_h=4, tile_capacity=768, max_tiles_per_gaussian=8,
              max_visible=2 ** 18)                # the CLI's render defaults
N_FRAMES = 8
WARMUP = 3
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_FP32_OPS_PER_S = 67e12    # H100 SXM FP32, outside the tensor cores
OPS_IN_RECT = 35               # per pixel-instance pair inside the parity rect
OPS_OUT_RECT = 4               # the rect test alone
OPS_APPLIED_BWD = 80           # K2 per applied pair: the forward recompute and the backward
#                                chain, plus one add per gradient column (14 + C) for the
#                                reduction; K2's other in-rect pairs cost the forward's count
N_STEPS = 8                    # training steps of the main path
TRAIN_TIMED = 20               # steps timed after warm-up
VOXEL = 0.1                    # densify voxel size (m)
# statistics from the first step on, one densify after the last step
OPT = dict(start_stat=0, update_from=0, update_interval=N_STEPS, update_until=10 ** 6)

TOL = {"feat_mean": 1e-5, "feat_max": 2e-2, "depth_mean": 1e-3, "depth_max": 2.0}
K2_TOL = {"mean": 1e-5, "atol": 2e-5, "far_count": 64, "max": 1e-3}
GRAD_TOL = {"rel_norm": 1e-2, "cos": 0.999}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def check_against(name: str, got, want, C: int) -> dict:
    """|got - want| over [T, 8, NPIX] (or [C+2]-row image stacks): feature
    and T rows against the feature tolerance, the depth row against the
    depth tolerance. Returns the error summary; fails out of tolerance."""
    import torch

    d = (got - want).abs()
    rows = list(range(C)) + [C + 1]
    feat, dep = d[:, rows], d[:, C]
    err = {
        "feat_mean": float(feat.mean()), "feat_max": float(feat.max()),
        "depth_mean": float(dep.mean()), "depth_max": float(dep.max()),
        "n_pix_feat_gt_1e-4": int((feat.amax(1) > 1e-4).sum()),
    }
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite output")
    for k, lim in TOL.items():
        if not err[k] <= lim:
            fail(f"{name}: {k} = {err[k]:.3e} exceeds {lim:.1e} ({err})")
    print(f"# {name}: {err}", file=sys.stderr)
    return err


def time_ms(fn, iters: int, warmup: int) -> list:
    """Per-call device time in ms from CUDA events, after `warmup` calls."""
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
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(iters)]


def walked_pairs(inst, counts, pix, C: int, cfg, group: int = 16):
    """Pixel-instance pairs that K1's sequential walk visits on these inputs
    (each pixel's live rows up to and including its first transmittance
    crossing), as (applied, other in rect, out of rect): the pairs that pass
    and are blended (K2 runs its backward chain and reduction on these
    alone), the other pairs inside the instance's parity rect (the alpha
    arithmetic, then a failed test or the crossing), and the pairs outside
    it (the rect test alone)."""
    import torch

    from lidargs_torch.ops.projection import PackedCols as PC

    T, K, _ = inst.shape
    rc = PC.rect(C).start
    k = torch.arange(K, device=inst.device)[None, :, None]
    n_app = n_in = n_out = 0
    for t0 in range(0, T, group):
        r = inst[t0:t0 + group]
        col = lambda i: r[:, :, i, None]                            # [g,K,1]
        dirx, diry, dirz, px, py = (pix[t0:t0 + group, i, None, :] for i in range(5))
        live = k < counts[t0:t0 + group, None, None]
        in_rect = (live & (px >= col(rc)) & (px < col(rc + 1))
                   & (py >= col(rc + 2)) & (py < col(rc + 3)))
        dx, dy, dz = col(0) - dirx, col(1) - diry, col(2) - dirz
        ddx = dx * col(3) + dy * col(4) + dz * col(5)
        ddy = dx * col(6) + dy * col(7) + dz * col(8)
        power = -0.5 * (col(9) * ddx * ddx + col(11) * ddy * ddy) - col(10) * ddx * ddy
        alpha = (col(PC.OPACITY) * torch.exp(power)).clamp_max(cfg.alpha_clamp)
        passed = in_rect & (power <= 0.0) & (alpha >= cfg.alpha_min)
        t_incl = torch.cumprod(torch.where(passed, 1.0 - alpha, 1.0), dim=1)
        cross = (passed & (t_incl < cfg.transmittance_min)).to(torch.int32)
        visited = live & ((torch.cumsum(cross, 1) - cross) == 0)
        n_app += int((visited & passed & (cross == 0)).sum())
        n_in += int((visited & in_rect).sum())
        n_out += int((visited & ~in_rect).sum())
    return n_app, n_in - n_app, n_out


def check_dinst(got, want, C: int) -> dict:
    """K2's dinst against the plain version's, each column scaled by its
    largest magnitude; fails out of K2_TOL."""
    import torch

    nv = 14 + C
    if not bool(torch.isfinite(got).all()):
        fail("K2: non-finite dinst")
    if bool((got[..., nv:] != 0).any()):
        fail("K2: nonzero rect/center/valid/pad columns")
    scale = want[..., :nv].abs().amax(dim=(0, 1)).clamp_min(1e-30)
    d = (got[..., :nv] - want[..., :nv]).abs() / scale
    err = {"mean": float(d.mean()), "max": float(d.max()),
           "far_count": int((d > K2_TOL["atol"]).sum()),
           "max_abs": float((got - want).abs().max()),
           "mean_abs": float((got - want).abs().mean()),
           "rows_touched": int((want[..., :nv].abs().amax(-1) > 0).sum())}
    for k in ("mean", "far_count", "max"):
        if not err[k] <= K2_TOL[k]:
            fail(f"K2 vs plain: {k} = {err[k]:.3e} exceeds {K2_TOL[k]:.1e} ({err})")
    print(f"# K2 vs plain (one step's inputs): {err}", file=sys.stderr)
    return err


def grad_diff(a: dict, b: dict) -> dict:
    """Per parameter leaf: relative norm of a - b and the cosine of a and b
    (b is the reference)."""
    from lidargs_torch.train.optim import tree_leaves

    import torch

    names = []

    def walk(t, path):
        for k in t:
            if isinstance(t[k], dict):
                walk(t[k], f"{path}{k}/")
            else:
                names.append(path + k)
    walk(a, "")
    out = {}
    for name, x, y in zip(names, tree_leaves(a), tree_leaves(b)):
        x, y = x.double().flatten(), y.double().flatten()
        ny = float(y.norm())
        out[name] = {
            "rel_norm": float((x - y).norm()) / ny if ny > 0 else float((x - y).norm()),
            "cos": float(x @ y) / (float(x.norm()) * ny) if ny > 0 else 1.0,
            "max_abs": float((x - y).abs().max()), "norm": ny,
        }
    return out


@contextlib.contextmanager
def plain_composite(ck):
    """Route the composite autograd function through the plain PyTorch
    versions of K1 and K2 (they are looked up at call time), for holding
    the kernels' gradients against theirs."""
    saved = ck.composite_tiles, ck.composite_tiles_bwd
    ck.composite_tiles, ck.composite_tiles_bwd = ck.composite_tiles_plain, ck.composite_tiles_bwd_plain
    try:
        yield
    finally:
        ck.composite_tiles, ck.composite_tiles_bwd = saved


def profile_render(render, frames: int = 3) -> dict:
    """torch.profiler over `frames` renders (after one untimed profiled
    render that warms the tracer up): device time and device-side launches
    per frame, in total and for the costliest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        v = getattr(e, "device_time_total", None)
        return v if v is not None else getattr(e, "cuda_time_total", 0.0)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        render()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            render()
        torch.cuda.synchronize()
    # the device's own rows (kernels, copies, memsets); the operator rows
    # that launched them would count the same time again
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    if not kernels:
        return {"frames": frames, "device_ms_per_frame": "not measured"}
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    return {
        "frames": frames,
        "device_ms_per_frame": sum(dev_us(e) for e in kernels) / 1e3 / frames,
        "device_launches_per_frame": sum(e.count for e in kernels) / frames,
        "top": [{"name": e.key[:90], "ms_per_frame": dev_us(e) / 1e3 / frames,
                 "calls_per_frame": e.count / frames} for e in top],
    }


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a CUDA device")
    run(torch.device("cuda", 0))


def run(dev) -> None:
    import numpy as np
    import torch

    import lidargs_torch
    if Path(lidargs_torch.__file__).resolve().parents[1] != ROOT:
        fail(f"lidargs_torch imported from {lidargs_torch.__file__}, not from {ROOT}")
    from lidargs_torch.config import ModelConfig, RasterConfig
    from lidargs_torch.lidar import LidarFrame, uniform_beam_inclinations
    from lidargs_torch.models.field import field_splats, render_field
    from lidargs_torch.ops import composite_kernel as ck
    from lidargs_torch.ops.projection import preprocess_gaussians
    from lidargs_torch.ops.rasterize import cull_sorted_rows, render_tiled, tile_inputs
    from lidargs_torch.ops.reference import render_reference
    from lidargs_torch.train import measure_fps, run_eval
    from lidargs_torch.utils import cuda_build
    from lidargs_torch.utils.testing import make_scene, sensor_poses, shell_field

    card_csv = card()
    print(f"# card: {card_csv}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr)

    # --- build every kernel of the path ---
    t0 = time.perf_counter()
    libs = cuda_build.build(["composite_fwd", "composite_bwd"])
    build_s = time.perf_counter() - t0
    for name, lib in libs.items():
        log = lib.with_suffix(".log").read_text().strip()
        print(f"# built {name} in {build_s:.1f} s:\n{log}", file=sys.stderr)

    # --- the full-width scene (CLI render defaults h4/K768/cap8) ---
    mcfg = ModelConfig(**MODEL)
    rcfg = RasterConfig(**RASTER)
    C = mcfg.color_channel
    params, valid = shell_field(mcfg, N_ANCHORS, seed=0, device=dev)
    beams = uniform_beam_inclinations(2.4, 20.9, H)
    gt0 = np.zeros((3, H, W), np.float32)
    frames = [LidarFrame.from_lidar2world(p, beams, gt0, uid=i, device=dev)
              for i, p in enumerate(sensor_poses(N_FRAMES, seed=1))]
    bg = torch.zeros(2, device=dev)

    # --- 1. the main path: frames through measure_fps ---
    with torch.no_grad():
        ck.launches = 0
        res = measure_fps(params, valid, frames, mcfg, rcfg, bg, warmup=WARMUP, device=dev)
        k1_launches = ck.launches
    if k1_launches != N_FRAMES:
        fail(f"K1 launched {k1_launches} times for {N_FRAMES} frames")
    for i, out in enumerate(res.outputs):
        if tuple(out.color.shape) != (C, H, W) or tuple(out.depth.shape) != (H, W):
            fail(f"frame {i}: shapes {tuple(out.color.shape)}, {tuple(out.depth.shape)}")
        for name in ("color", "depth", "occ"):
            if not bool(torch.isfinite(getattr(out, name)).all()):
                fail(f"frame {i}: non-finite {name}")
    occ = [float(o.occ.mean()) for o in res.outputs]
    if not min(occ) > 0.0:
        fail(f"empty render: mean occupancy per frame {occ}")
    main_path = {
        "frames": N_FRAMES, "warmup": WARMUP, "fps_host_clock": res.fps,
        "host_ms_per_frame": [t * 1e3 for t in res.seconds],
        "mean_occ": occ,
        "n_overflow": [int(o.n_overflow) for o in res.outputs],
        "n_dropped": [int(o.n_dropped) for o in res.outputs],
        "n_visible": [int(o.visible.sum()) for o in res.outputs],
    }
    print(f"# main path: {json.dumps(main_path)}", file=sys.stderr)

    # --- 2. run_eval against a ground truth made from frame 0's render ---
    o0 = res.outputs[0]
    dmin, dmax = 5.0, 80.0
    gt = torch.stack([(o0.color[1] > 0.5).float(), o0.color[0].clamp(0.0, 1.0),
                      o0.depth.clamp(dmin, dmax)]).cpu().numpy()
    fr_gt = LidarFrame.from_lidar2world(sensor_poses(N_FRAMES, seed=1)[0], beams, gt,
                                        uid=0, device=dev)
    with torch.no_grad():
        ev = run_eval(params, valid, {"test": [fr_gt]}, mcfg, rcfg, bg,
                      str(ROOT / "build" / "chip_smoke"), dmin, dmax, device=dev)
    m = ev["test"]
    if not (m["intensity_l1"] == 0.0 and m["raydrop_acc"] == 1.0 and m["depth_mae"] == 0.0):
        fail(f"run_eval on a deterministic re-render is not exact: {m}")

    # --- 3. K1 render against the golden O(P*HW) renderer, small scene ---
    sc = make_scene(seed=3, n=400, H=32, W=256)
    t = lambda x: torch.from_numpy(x).to(dev)
    small = RasterConfig(tile_h=4, tile_capacity=512, max_tiles_per_gaussian=64,
                         max_visible=512, chunk=8)
    bg_s = torch.tensor([0.3, 0.7], device=dev)
    with torch.no_grad():
        sp = preprocess_gaussians(t(sc.means3d), t(sc.scales), t(sc.quats),
                                  t(sc.opacities), t(sc.feat), t(sc.mask),
                                  t(sc.w2s_rot), t(sc.w2s_trans), t(sc.beams), sc.W, small)
        tiled = render_tiled(sp, t(sc.beams), sc.W, bg_s, small)
        ref_c, ref_d, _ref_occ, ref_T = render_reference(sp, t(sc.beams), sc.W, bg_s, small)
    if int(tiled.n_overflow) != 0 or not float(tiled.occ.max()) > 0.5:
        fail(f"small scene: overflow {int(tiled.n_overflow)}, max occ {float(tiled.occ.max())}")
    stack = lambda c, d, T: torch.cat([c, d[None], T[None]])[None]
    err_ref = check_against("tiled K1 vs golden (small scene)",
                            stack(tiled.color, tiled.depth, tiled.final_T),
                            stack(ref_c, ref_d, ref_T), C)

    # --- 4. K1 against plain PyTorch on the main path's inputs of frame 0 ---
    with torch.no_grad():
        splats = field_splats(params, valid, frames[0], mcfg, rcfg)[0]
        pkv, _ = cull_sorted_rows(splats, rcfg)
        inst, counts, pix, _ = tile_inputs(pkv, frames[0].beams, W, rcfg, C)
        out_k = ck.composite_tiles(inst, counts, pix, C, rcfg)
        out_p = ck.composite_tiles_plain(inst, counts, pix, C, rcfg)
    torch.cuda.synchronize()
    err_k1 = check_against("K1 vs plain (frame 0 inputs)", out_k, out_p, C)
    shapes = {"inst": list(inst.shape), "counts": list(counts.shape),
              "pix": list(pix.shape), "mean_count": float(counts.float().mean()),
              "max_count": int(counts.max())}

    # --- 5. timing (CUDA events) and K1's bound from this run's inputs ---
    with torch.no_grad():
        k1_ms = time_ms(lambda: ck.composite_tiles(inst, counts, pix, C, rcfg), 50, 5)
        plain_ms = time_ms(lambda: ck.composite_tiles_plain(inst, counts, pix, C, rcfg), 5, 1)
        render = lambda: render_field(params, valid, frames[0], mcfg, rcfg, bg)
        render_ms = time_ms(render, 30, 3)
        n_app, n_other, n_out = walked_pairs(inst, counts, pix, C, rcfg)
        prof = profile_render(render)
    n_in = n_app + n_other
    n_bytes = 4 * (inst.numel() + counts.numel() + pix.numel() + out_k.numel())
    n_ops = OPS_IN_RECT * n_in + OPS_OUT_RECT * n_out
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_OPS_PER_S * 1e3
    med = lambda xs: float(np.median(xs))

    # --- 7-9. training, K2 against plain, timing ---
    train, k2 = train_phases(dev, params, valid, mcfg, rcfg, beams)

    timing = {
        "card": card_csv,
        "render_ms_per_frame_median": med(render_ms),
        "render_ms_per_frame_min": min(render_ms), "render_ms_per_frame_max": max(render_ms),
        "render_samples": len(render_ms),
        "fps_from_median": 1e3 / med(render_ms),
        "k1_ms_median": med(k1_ms), "k1_samples": len(k1_ms),
        "plain_ms_median": med(plain_ms), "plain_samples": len(plain_ms),
        "k1_inputs": shapes,
        "k1_bound": {"bytes": n_bytes, "bytes_ms": t_bytes, "ops": n_ops, "ops_ms": t_ops,
                     "pairs_in_rect": n_in, "pairs_applied": n_app, "pairs_out_rect": n_out},
        "build_s": build_s,
        "main_path": main_path,
        "golden_small_err": err_ref,
        "profile": prof,
        "train": train,
    }
    if isinstance(prof["device_ms_per_frame"], float):
        timing["device_busy_share"] = prof["device_ms_per_frame"] / med(render_ms)
    kernels = {
        "card": card_csv,
        "kernels": [{
            "name": "composite_fwd",
            "route": "cuda",
            "source": "lidargs_torch/csrc/composite_fwd.cu",
            "replaces": "lidargs_tpu/ops/pallas_composite.py:175",
            "launches": k1_launches,
            "launches_train": train["k1_launches"],
            "max_abs_err": max(err_k1["feat_max"], err_k1["depth_max"]),
            "mean_abs_err": {"feat": err_k1["feat_mean"], "depth": err_k1["depth_mean"]},
            "ms": med(k1_ms),
            "plain_ms": med(plain_ms),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        }, k2],
    }
    print(json.dumps({"timing": timing}))
    print(json.dumps(kernels))
    print(card_csv)
    # the run uses one device
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1}}))


def train_phases(dev, params, valid, mcfg, rcfg, beams):
    """Phases 7-9 on the render scene: (summary for the timing line, K2's
    entry of the kernels line)."""
    import numpy as np
    import torch

    from lidargs_torch.config import OptConfig
    from lidargs_torch.lidar import LidarFrame
    from lidargs_torch.models.field import AnchorField
    from lidargs_torch.ops import composite_kernel as ck
    from lidargs_torch.train import Trainer, init_train_state, loss_and_grads
    from lidargs_torch.train.optim import tree_leaves
    from lidargs_torch.utils.testing import sensor_poses

    C = mcfg.color_channel
    med = lambda xs: float(np.median(xs))
    ocfg = OptConfig(**OPT)
    bg = torch.zeros(2, device=dev)
    trainer = Trainer(mcfg=mcfg, ocfg=ocfg, rcfg=rcfg, bg=bg)
    # GT as the JAX package's train-step benchmark draws it
    rng = np.random.default_rng(4)
    frames = []
    for i, pose in enumerate(sensor_poses(N_STEPS, seed=2)):
        gt = np.zeros((3, H, W), np.float32)
        gt[0] = rng.uniform(size=(H, W)) > 0.2
        gt[1] = rng.uniform(size=(H, W)) * gt[0]
        gt[2] = rng.uniform(5.0, 70.0, size=(H, W)) * gt[0]
        frames.append(LidarFrame.from_lidar2world(pose, beams, gt, uid=i, device=dev))
    state0 = init_train_state(AnchorField(params=params, valid=valid, voxel_size=VOXEL), mcfg)

    # --- 7. the main path: N_STEPS training steps ---
    state, losses = state0, []
    ck.launches = ck.bwd_launches = 0
    for it in range(1, N_STEPS + 1):
        state, m = trainer.step(state, frames[it - 1], it)
        losses.append({f: float(getattr(m.loss, f)) for f in m.loss._fields})
    k1_launches, k2_launches = ck.launches, ck.bwd_launches
    if k1_launches != N_STEPS or k2_launches != N_STEPS:
        fail(f"{N_STEPS} steps launched K1 {k1_launches} and K2 {k2_launches} times")
    if not all(np.isfinite(list(l.values())).all() for l in losses):
        fail(f"non-finite loss terms: {losses}")
    moved = 0
    for a, b in zip(tree_leaves(state.params), tree_leaves(state0.params)):
        if not bool(torch.isfinite(a).all()):
            fail("non-finite parameters after training")
        moved += int((a != b).sum())
    if moved == 0:
        fail("training left every parameter as it was")
    stats = {
        "anchor_demon_max": float(state.anchor_demon.max()),
        "offset_denom_sum": float(state.offset_denom.sum()),
        "offset_grad_accum_sum": float(state.offset_grad_accum.sum()),
        "opacity_accum_sum": float(state.opacity_accum.sum()),
    }
    if not (stats["anchor_demon_max"] == N_STEPS and stats["offset_denom_sum"] > 0
            and stats["offset_grad_accum_sum"] > 0 and stats["opacity_accum_sum"] > 0):
        fail(f"densification statistics did not accumulate: {stats}")
    n_before = int(state.valid.sum())
    if not trainer.should_densify(n_before, N_STEPS):
        fail("the densify cadence does not fire after the last step")
    dense, dstats = trainer.densify(state, torch.Generator(device=dev).manual_seed(0), VOXEL)
    densify = {"n_anchors_before": n_before, "n_grown": int(dstats.n_grown),
               "n_pruned": int(dstats.n_pruned),
               "n_capacity_dropped": int(dstats.n_capacity_dropped),
               "n_anchors_after": int(dense.valid.sum())}
    if densify["n_anchors_after"] != n_before + densify["n_grown"] - densify["n_pruned"]:
        fail(f"densify: anchor count does not add up: {densify}")
    print(f"# train: losses {losses}; stats {stats}; densify {densify}", file=sys.stderr)

    # --- 8. K2 against plain on one step's inputs; gradients against plain ---
    frame = frames[0]
    grads = lambda: loss_and_grads(state, frame, bg, mcfg, rcfg, ocfg)[1:]
    captured = []
    run_k2 = ck.composite_tiles_bwd

    def record(*args):
        captured.append(args)
        return run_k2(*args)

    ck.composite_tiles_bwd = record
    try:
        g_k, pg_k = grads()
    finally:
        ck.composite_tiles_bwd = run_k2
    g_k2, pg_k2 = grads()
    with plain_composite(ck):
        g_p, pg_p = grads()
    torch.cuda.synchronize()
    for g in tree_leaves(g_k) + [pg_k]:
        if not bool(torch.isfinite(g).all()):
            fail("non-finite gradients")
    bwd_args = captured[0]
    with torch.no_grad():
        d_k = run_k2(*bwd_args)
        d_p = ck.composite_tiles_bwd_plain(*bwd_args)
    torch.cuda.synchronize()
    err_k2 = check_dinst(d_k, d_p, C)
    vs_plain = grad_diff({**g_k, "proxy": pg_k}, {**g_p, "proxy": pg_p})
    run_to_run = grad_diff({**g_k2, "proxy": pg_k2}, {**g_k, "proxy": pg_k})
    for name, e in vs_plain.items():
        if e["norm"] == 0:
            continue
        if not (e["rel_norm"] <= GRAD_TOL["rel_norm"] and e["cos"] >= GRAD_TOL["cos"]):
            fail(f"gradient of {name}, kernels vs plain: {e}")
    print(f"# grads vs plain: {vs_plain}\n# grads run to run: {run_to_run}", file=sys.stderr)

    # --- 9. timing: the step, K2, the plain backward; K2's bound; profile ---
    inst, counts, pix, res, g = bwd_args[:5]
    held = [state]

    def one_step():
        held[0], _ = trainer.step(held[0], frame, 1)

    step_ms = time_ms(one_step, TRAIN_TIMED, 3)
    k2_ms = time_ms(lambda: run_k2(*bwd_args), 50, 5)
    plain_bwd_ms = time_ms(lambda: ck.composite_tiles_bwd_plain(*bwd_args), 5, 1)
    n_app, n_other, n_out = walked_pairs(inst, counts, pix, C, rcfg)
    # profile_render reports per call; a call here is one step
    prof = profile_render(one_step, frames=3)
    n_bytes = 4 * (inst.numel() + counts.numel() + pix.numel() + res.numel() + g.numel()
                   + d_k.numel())
    n_ops = ((OPS_APPLIED_BWD + 14 + C) * n_app + OPS_IN_RECT * n_other
             + OPS_OUT_RECT * n_out)
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_OPS_PER_S * 1e3
    train = {
        "steps": N_STEPS, "k1_launches": k1_launches, "k2_launches": k2_launches,
        "loss_first": losses[0], "loss_last": losses[-1], "stats": stats, "densify": densify,
        "step_ms_median": med(step_ms), "step_ms_min": min(step_ms),
        "step_ms_max": max(step_ms), "step_samples": len(step_ms),
        "k2_ms_median": med(k2_ms), "k2_samples": len(k2_ms),
        "plain_bwd_ms_median": med(plain_bwd_ms), "plain_bwd_samples": len(plain_bwd_ms),
        "k2_bound": {"bytes": n_bytes, "bytes_ms": t_bytes, "ops": n_ops, "ops_ms": t_ops,
                     "pairs_applied": n_app, "pairs_in_rect_other": n_other,
                     "pairs_out_rect": n_out},
        "k2_err": err_k2,
        "grad_vs_plain_worst": max(vs_plain.items(), key=lambda kv: kv[1]["rel_norm"]),
        "grad_run_to_run_max_rel_norm": max(e["rel_norm"] for e in run_to_run.values()),
        "grad_run_to_run_max_abs": max(e["max_abs"] for e in run_to_run.values()),
        "profile": prof,
    }
    if isinstance(prof["device_ms_per_frame"], float):
        train["device_busy_share"] = prof["device_ms_per_frame"] / med(step_ms)
    k2 = {
        "name": "composite_bwd",
        "route": "cuda",
        "source": "lidargs_torch/csrc/composite_bwd.cu",
        "replaces": "lidargs_tpu/ops/pallas_composite.py:224",
        "launches": k2_launches,
        "max_abs_err": err_k2["max_abs"],
        "mean_abs_err": err_k2["mean_abs"],
        "column_scaled_err": {"mean": err_k2["mean"], "max": err_k2["max"],
                              "far_count": err_k2["far_count"]},
        "ms": med(k2_ms),
        "plain_ms": med(plain_bwd_ms),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }
    return train, k2


if __name__ == "__main__":
    main()
