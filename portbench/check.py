"""What decides `correct`: the reference on the same inputs, and the
numbers that compare the program's results with it.

Training: the reference follows the program's first steps (the window's
own call and feed, on the frames the CLI's schedule drew) from the same
parameters and a fresh Adam. Three numbers, each taken by the worst leaf:
  * `loss_gap`: |loss - reference loss| / |reference loss|, the worst step;
  * `grad_gap`: the gap between the norms of the program's first gradient
    (as Adam's first moment holds it) and the reference's, over the larger
    of the reference's norm of that leaf and the median leaf's;
  * `step_gap`: the same of the parameters' change after the steps. Leaves
    whose reference gradient is under a thousandth of the median leaf's
    are left out: Adam moves them by round-off alone.
Re-simulation: the reference renders the frames of the checked poses. Per
pixel the error is the largest of the intensity's, the ray drop's and the
depth's over the far plane. Two numbers, each the worst checked frame's:
  * `median_err`: the median error over the pixels either side covers;
  * `far_share`: the share of pixels whose error exceeds `far_atol`.

The reference runs once the program's state is freed, with TF32 off (the
configuration's float32); `tf32=True` computes it with TF32 on, the
control. `rows` plants the fault "half of the batch left out" in it.
"""
from __future__ import annotations

import contextlib
import statistics
from typing import Optional

import torch

from . import counts
from .drive import clone_tree, dataclass_from
from .reference.config import LrSchedule, ModelConfig, OptConfig, RasterConfig
from .reference.field import Frame, render
from .reference.optim import init_adam, tree_leaves
from .reference.train import train_step

NOUGHT = 1e-3                  # a leaf's gradient under this share of the median leaf's


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products in TF32 (`tf32`) or in full float32."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def ref_configs(config: dict):
    """(ModelConfig, RasterConfig, OptConfig) of the reference."""
    return (dataclass_from(ModelConfig, config["model"]),
            dataclass_from(RasterConfig, config["raster"]),
            dataclass_from(OptConfig, config["opt"], (LrSchedule,)))


def ref_frame(pose, gt, beams) -> Frame:
    return Frame(pose.w2s_rot, pose.w2s_trans, pose.center, beams, gt)


def live_params(params: dict, n_live: int) -> int:
    """Parameter elements of the live anchors and of the heads."""
    return sum(x.numel() if k.startswith("mlp_") else x[0].numel() * n_live
               for k, v in params.items() for x in tree_leaves(v))


def reference_train(cell, inputs, frame_ids: list, tf32: bool = False,
                    rows: Optional[int] = None):
    """The reference's steps on the train frames `frame_ids`: {losses [n],
    first_grad (tree), params (tree)}."""
    mcfg, rcfg, ocfg = ref_configs(cell.config)
    variant = cell.config["variant"]
    beams = inputs.scene.beams
    params, valid = clone_tree(inputs.params), inputs.valid
    opt = init_adam(params)
    bg = torch.zeros((mcfg.color_channel,), device=valid.device)
    step0 = cell.traffic["first_iteration"] - 1
    losses, first_grad = [], None
    with precision(tf32):
        for i, fid in enumerate(frame_ids):
            pose, gt = inputs.scene.train[fid]
            params, opt, loss, grads = train_step(params, opt, valid, step0 + i,
                                                  ref_frame(pose, gt, beams), bg, mcfg, rcfg,
                                                  ocfg, variant, rows)
            losses.append(loss)
            if first_grad is None:
                first_grad = grads
    return {"losses": torch.stack(losses), "first_grad": first_grad, "params": params}


def reference_work(cell, scene, params: dict, valid: torch.Tensor, frame_ids: list) -> list:
    """[counts.Work] of a training step on each train frame of `frame_ids`,
    on the field (params, valid): what the reference's render derives
    (visible anchors, kept gaussians, tile lists) and the live parameters.
    The field is the one a traced segment trained, so the counts follow the
    work the segment timed; they decide nothing of `correct`."""
    mcfg, rcfg, _ = ref_configs(cell.config)
    variant = cell.config["variant"]
    bg = torch.zeros((mcfg.color_channel,), device=valid.device)
    live = live_params(params, int(valid.sum()))
    work = []
    with precision(False), torch.no_grad():
        for fid in frame_ids:
            pose, gt = scene.train[fid]
            probe: dict = {}
            render(params, valid, ref_frame(pose, gt, scene.beams), mcfg, rcfg, bg, variant,
                   probe)
            work.append(_work(probe, gt, mcfg, rcfg, variant, live))
    return work


def reference_render(cell, inputs, poses: dict, tf32: bool = False, stages=()):
    """The reference's frames of `poses` ({index: Pose}): {frames: {index:
    (color, depth)}, work: [counts.Work]}. `stages` ([(registry.Stage,
    drawn)], from `run.make_drive`) are applied to each frame in turn."""
    mcfg, rcfg, _ = ref_configs(cell.config)
    H, W = cell.config["sensor"]["H"], cell.config["sensor"]["W"]
    valid = inputs.valid
    gt = torch.zeros((3, H, W), device=valid.device)
    bg = torch.zeros((mcfg.color_channel,), device=valid.device)
    staged = tuple((s.name, _bound(*s.work(drawn, H, W))) for s, drawn in stages)
    frames, work = {}, []
    with precision(tf32), torch.no_grad():
        for i, pose in poses.items():
            probe: dict = {}
            out, _ = render(inputs.params, valid, ref_frame(pose, gt, inputs.scene.beams), mcfg,
                            rcfg, bg, cell.config["variant"], probe)
            color, depth = out.color, out.depth
            for s, drawn in stages:
                color, depth = s.reference(drawn, color, depth)
            frames[i] = (color, depth)
            work.append(_work(probe, gt, mcfg, rcfg, cell.config["variant"], 0)
                        ._replace(stages=staged))
    return {"frames": frames, "work": work}


def _bound(ops: int, nbytes: int) -> counts.Bound:
    return counts.Bound(bytes=nbytes, ops=ops)


def _work(probe: dict, gt, mcfg, rcfg, variant: str, live: int) -> counts.Work:
    fwd, bwd = counts.composite_bounds(probe["lists"], mcfg.color_channel, rcfg, variant)
    return counts.Work(probe["visible_anchors"], probe["kept"], gt.shape[-2] * gt.shape[-1],
                       live, fwd, bwd)


def _norms(tree) -> list:
    return [float(x.double().norm()) for x in tree_leaves(tree)]


def _gap(got: list, want: list, keep: Optional[list] = None) -> float:
    """The worst leaf's |got - want| over max(want, the median leaf's want)."""
    med = statistics.median(want)
    gaps = [abs(g - w) / max(w, med) for i, (g, w) in enumerate(zip(got, want))
            if (keep is None or keep[i]) and max(w, med) > 0]
    return max(gaps, default=0.0)


def train_numbers(got: dict, want: dict, start: dict) -> dict:
    """The three training numbers of `got` (the program's, or a control's)
    against `want` (the reference's), both from the parameters `start`."""
    g_ref = _norms(want["first_grad"])
    med = statistics.median(g_ref)
    keep = [g >= NOUGHT * med for g in g_ref]
    delta = lambda p: {k: _diff(p[k], start[k]) for k in start}
    lg = (got["losses"].double() - want["losses"].double()).abs() / want["losses"].double().abs()
    return {"loss_gap": float(lg.max()) if torch.isfinite(lg).all() else float("inf"),
            "grad_gap": _gap(_norms(got["first_grad"]), g_ref),
            "step_gap": _gap(_norms(delta(got["params"])), _norms(delta(want["params"])), keep)}


def _diff(a, b):
    if isinstance(a, dict):
        return {k: _diff(a[k], b[k]) for k in a}
    return a.double() - b.double()


def pixel_err(got: tuple, want: tuple, far: float) -> torch.Tensor:
    """[H, W] the largest of the intensity, ray drop and depth / far errors."""
    (gc, gd), (wc, wd) = got, want
    d = torch.stack([(gc[0] - wc[0]).abs(), (gc[1] - wc[1]).abs(), (gd - wd).abs() / far])
    return d.amax(0).double()


def render_numbers(got: dict, want: dict, far: float, far_atol: float) -> dict:
    med, share = 0.0, 0.0
    for i, w in want.items():
        g = got[i]
        err = pixel_err(g, w, far)
        if not torch.isfinite(err).all():
            return {"median_err": float("inf"), "far_share": 1.0}
        covered = (g[1] > 0) | (w[1] > 0)
        if covered.any():
            med = max(med, float(err[covered].median()))
        share = max(share, float((err > far_atol).double().mean()))
    return {"median_err": med, "far_share": share}


def judge(numbers: dict, limits: dict) -> bool:
    return all(k in numbers and numbers[k] <= v for k, v in limits.items())
