"""Render-only entry points: frame rate and the evaluation sweep.

Counterparts of `measure_fps` and `run_eval` in `lidargs_tpu/train/cli.py`,
taking the field (params + anchor mask) and the frames directly; the CLI's
`train/cli.py` calls them with a scene's. Each renders through the variant's
render path, as the JAX package's `Trainer.render` dispatches it:
`render_field` for `variant="beam"` (the default), `render_field_surfel`
for `variant="surfel"`; on the card unless the caller passes
`device="cpu"`. On the card each replays the render as one CUDA graph
(`train/graphs.py` `RenderGraphs`, the counterpart of the CLI's jitted
renders), captured at the first frame and replayed for every frame; on the
CPU each renders eagerly. `run_eval` also takes the ray-drop refiner and the LPIPS
distance as callables, which the CLI builds from their weights files; the
refiner runs inside the render's program (`RenderGraphs(refine=...)`), as
`Trainer.render` runs it.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Union

import torch

from ..config import ModelConfig, RasterConfig
from ..lidar.frames import LidarFrame
from ..ops.rasterize import RenderOut
from ..ops.surfel import SurfelOut
from ..utils.device import resolve_device
from ..utils.profiling import telemetry
from .graphs import RenderGraphs
from .metrics import evaluate_frame, mean_metrics

log = logging.getLogger(__name__)


def _params_to(params: dict, dev: torch.device) -> dict:
    return {k: _params_to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in params.items()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class FpsResult(NamedTuple):
    fps: float                 # frames after warmup over the time the loop took for them
    seconds: List[float]       # per-frame wall clock, warmup frames included
    outputs: List[Union[RenderOut, SurfelOut]]   # each frame's render, in order


def measure_fps(params: dict, valid: torch.Tensor, frames: List[LidarFrame],
                mcfg: ModelConfig, rcfg: RasterConfig, bg: torch.Tensor,
                warmup: int = 5, device="cuda", variant: str = "beam") -> FpsResult:
    """Per-frame wall clock of the render, each frame ending in a device
    synchronize; the rate is the frames after the first `warmup` over the
    time the loop took for them (the warmup frames hold the graph's capture
    on the card, as JAX's hold its compile). `variant` picks the render path ("beam" or
    "surfel"). Each frame's outputs are its own (cloned from the graph's)."""
    if len(frames) <= warmup:
        raise ValueError(f"{len(frames)} frames leave none after {warmup} warmup frames")
    dev = resolve_device(device)
    params, valid, bg = _params_to(params, dev), valid.to(dev), bg.to(dev)
    render = RenderGraphs(variant, mcfg, rcfg, bg)
    frames = [fr.to(dev) for fr in frames]
    ts, outs = [], []
    for i, fr in enumerate(frames):
        t0 = time.perf_counter()
        if i == warmup:
            t_loop = t0
        out = render(params, valid, fr)
        _sync(dev)
        ts.append(time.perf_counter() - t0)
        outs.append(out)
    fps = (len(frames) - warmup) / (time.perf_counter() - t_loop)
    log.info("[fps] %.2f frames/s over %d frames", fps, len(ts) - warmup)
    return FpsResult(fps=fps, seconds=ts, outputs=outs)


def run_eval(params: dict, valid: torch.Tensor,
             splits: Dict[str, List[LidarFrame]], mcfg: ModelConfig,
             rcfg: RasterConfig, bg: torch.Tensor, model_path: str,
             depth_min: float = 5.0, depth_max: float = 80.0,
             device="cuda", variant: str = "beam", compute_chamfer: bool = False,
             refine: Optional[Callable] = None, lpips_fn: Optional[Callable] = None) -> dict:
    """Render every frame of each split (e.g. {"test": [...], "train":
    [...]}), score it with `evaluate_frame` (with the chamfer distance and
    F-score when `compute_chamfer`), and write the per-split means to
    `<model_path>/results.json` and the per-frame metrics to
    `<model_path>/per_view.json`. Returns both in one dict.

    `refine(color, depth) -> color` replaces each render's [intensity,
    raydrop] inside the render's program, before it is scored (the ray-drop
    refiner); `lpips_fn(a, b)` adds `intensity_lpips`, the distance of the
    clipped intensity render from the GT intensity under the GT hit mask.
    While the recorder (`utils/profiling.py` `telemetry`) is on, the frames'
    programs carry its stamps, as `Trainer.render`'s do."""
    dev = resolve_device(device)
    params, valid, bg = _params_to(params, dev), valid.to(dev), bg.to(dev)
    render = RenderGraphs(variant, mcfg, rcfg, bg, refine=refine)
    scope = telemetry.scope(dev) if telemetry.on else contextlib.nullcontext()
    results = {}
    for name, frames in splits.items():
        if not frames:
            log.info("[eval %s] no frames, skipped", name)
            continue
        per = []
        for fr in frames:
            fr = fr.to(dev)
            with torch.no_grad():
                with scope:
                    out = render(params, valid, fr)
                pv = evaluate_frame(out.color, out.depth, fr.gt_image, fr.beams,
                                    depth_min=depth_min, depth_max=depth_max,
                                    compute_chamfer=compute_chamfer)
                if lpips_fn is not None:
                    pv["intensity_lpips"] = float(lpips_fn(
                        out.color[0].clamp(0.0, 1.0), fr.gt_image[1] * fr.gt_image[0]))
            pv["visible_count"] = float(out.visible.sum())
            per.append(pv)
        m = mean_metrics(per)
        results[name] = m
        results[f"per_view_{name}"] = {f"{i:05d}": pv for i, pv in enumerate(per)}
        log.info("[eval %s] psnr=%.3f ssim=%.4f rd_acc=%.4f d_rmse=%.4f d_medae=%.4f%s",
                 name, m["intensity_psnr"], m["intensity_ssim"], m["raydrop_acc"],
                 m["depth_rmse"], m["depth_medae"],
                 f" cd={m['depth_cd']:.5f} f={m['depth_fscore']:.4f}" if compute_chamfer
                 else "")
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "results.json"), "w") as f:
        json.dump({k: v for k, v in results.items() if not k.startswith("per_view_")},
                  f, indent=2)
    with open(os.path.join(model_path, "per_view.json"), "w") as f:
        json.dump({k: v for k, v in results.items() if k.startswith("per_view_")},
                  f, indent=2)
    return results
