#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`lidargs_torch`).

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 chip_smoke.py

It builds every CUDA kernel of the render path from `lidargs_torch/csrc/`
(nvcc, sm_90a, into `build/lidargs_torch/`), then:

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
  6. lists the render's costliest device kernels from torch.profiler.

It prints a timing line, a `kernels` line, the card's name and power limit
(`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`) and, as
the last line, `{"ok": true, "device": {...}}`. Any failure exits non-zero
before that line; without a CUDA device it exits non-zero at once.

Tolerances, K1 against plain PyTorch on identical inputs: the kernel
multiplies the transmittance in sequence where the plain version takes a
chunked cumprod, so a pixel whose T*(1-alpha) sits at the 1e-4 threshold can
stop one instance earlier or later. Features and final T: mean |d| <= 1e-5,
max |d| <= 2e-2; depth (metres): mean |d| <= 1e-3, max |d| <= 2.0.
"""
from __future__ import annotations

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

TOL = {"feat_mean": 1e-5, "feat_max": 2e-2, "depth_mean": 1e-3, "depth_max": 2.0}


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
    crossing), split into those inside the instance's parity rect, which
    take the full alpha and blend arithmetic, and those outside, which take
    the rect test alone."""
    import torch

    from lidargs_torch.ops.projection import PackedCols as PC

    T, K, _ = inst.shape
    rc = PC.rect(C).start
    k = torch.arange(K, device=inst.device)[None, :, None]
    n_in = n_out = 0
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
        n_in += int((visited & in_rect).sum())
        n_out += int((visited & ~in_rect).sum())
    return n_in, n_out


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
    libs = cuda_build.build(["composite_fwd"])
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
        n_in, n_out = walked_pairs(inst, counts, pix, C, rcfg)
        prof = profile_render(render)
    n_bytes = 4 * (inst.numel() + counts.numel() + pix.numel() + out_k.numel())
    n_ops = OPS_IN_RECT * n_in + OPS_OUT_RECT * n_out
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_OPS_PER_S * 1e3
    med = lambda xs: float(np.median(xs))

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
                     "pairs_in_rect": n_in, "pairs_out_rect": n_out},
        "build_s": build_s,
        "main_path": main_path,
        "golden_small_err": err_ref,
        "profile": prof,
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
            "max_abs_err": max(err_k1["feat_max"], err_k1["depth_max"]),
            "mean_abs_err": {"feat": err_k1["feat_mean"], "depth": err_k1["depth_mean"]},
            "ms": med(k1_ms),
            "plain_ms": med(plain_ms),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        }],
    }
    print(json.dumps({"timing": timing}))
    print(json.dumps(kernels))
    print(card_csv)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(dev),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
