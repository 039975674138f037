"""The data-parallel training step over a batch of frames.

Counterpart of `lidargs_tpu/parallel/shard.py`. Each rank holds the
replicated state and its own share of the step's frames (a stacked
`LidarFrame`, `lidar/frames.py`); its frames run one after another, as the
JAX package's `lax.map` runs a shard's frames, each through
`loss_and_grads` (kernels K1 and K2 per beam frame, K5 and K6 per surfel
frame). Then, after the local backward:

  * ONE fused all-reduce (sum) over the mesh's data axis of a flat buffer
    holding every gradient leaf, the four O(C) densification statistics and
    the loss terms; the gradients and losses are then divided by the global
    batch B = local frames x data-axis size;
  * one small all-reduce (max) of n_visible, n_dropped and n_overflow, the
    largest of any frame of the batch;
  * `apply_step` (`train/trainer.py`), which `train_step` ends in too:
    Adam, and the statistics added, so B frames count B times, as running
    the single-frame loop B times would.

`local_sums` (the frames in turn) and `apply_sums` (the division and the
update) are the two halves around the collectives.

At world size 1 with B local frames this is the CLI's `--data_parallel 1
--dp_batch B`. The global batch is split over the data axis by
`Runtime.local_indices`, which raises when it does not divide evenly.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import torch

from ..config import ModelConfig, OptConfig, RasterConfig
from ..lidar.frames import LidarFrame, index_frame
from ..train.losses import LossTerms
from ..train.optim import tree_leaves, tree_unflatten
from ..train.trainer import (StepMetrics, Trainer, TrainState, apply_step, frame_stats,
                             loss_and_grads)
from .collectives import all_reduce_max, all_reduce_sum
from .mesh import Mesh, make_mesh


@torch.no_grad()
def local_sums(state: TrainState, frames: LidarFrame, bg, mcfg: ModelConfig,
               rcfg: RasterConfig, ocfg: OptConfig, update_stats: bool = True,
               variant: str = "beam"):
    """This rank's frames in turn: (flat [every gradient leaf, the four
    statistics when `update_stats`, the loss terms], each summed over the
    frames in order; [n_visible, n_dropped, n_overflow], the largest of any
    frame). `apply_sums` reads the flat buffer once it is summed over the
    data axis."""
    grads = stats = terms = None
    worst = []
    for i in range(frames.gt_image.shape[0]):
        (out, ng, anchor_vis, lt), g, proxy_grad = loss_and_grads(
            state, index_frame(frames, i), bg, mcfg, rcfg, ocfg, variant)
        g = tree_leaves(g)
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        if update_stats:
            s = frame_stats(state, out, ng, anchor_vis, proxy_grad)
            stats = s if stats is None else [a + b for a, b in zip(stats, s)]
        t = torch.stack([x.detach().to(torch.float32) for x in lt])
        terms = t if terms is None else terms + t
        worst.append(torch.stack([out.visible.sum().to(torch.int64),
                                  out.n_dropped.to(torch.int64),
                                  out.n_overflow.to(torch.int64)]))
    flat = torch.cat([x.reshape(-1) for x in grads + (stats or []) + [terms]])
    return flat, torch.stack(worst).amax(0)


@torch.no_grad()
def apply_sums(state: TrainState, flat: torch.Tensor, worst: torch.Tensor, B: int,
               ocfg: OptConfig, update_stats: bool = True):
    """The step from `local_sums`' buffers summed (flat) and maxed (worst)
    over the global batch of B frames: the gradients and losses divided by
    B, then `apply_step`. (new TrainState, StepMetrics)."""
    leaves = tree_leaves(state.params)
    accums = [state.opacity_accum, state.anchor_demon, state.offset_grad_accum,
              state.offset_denom] if update_stats else []
    sizes = [x.numel() for x in leaves + accums] + [len(LossTerms._fields)]
    pieces = torch.split(flat, sizes)
    n_g = len(leaves)
    grads = tree_unflatten(state.params, [(p / B).view_as(x)
                                          for p, x in zip(pieces[:n_g], leaves)])
    stats = list(pieces[n_g:-1]) if update_stats else None
    n_visible, n_dropped, n_overflow = worst
    metrics = StepMetrics(
        loss=LossTerms(*(pieces[-1] / B).unbind()),
        n_anchors=state.valid.sum(),
        n_visible=n_visible,
        n_dropped=n_dropped,
        n_overflow=n_overflow,
    )
    return apply_step(state, grads, stats, ocfg), metrics


@torch.no_grad()
def dp_train_step(state: TrainState, frames: LidarFrame, bg, mcfg: ModelConfig,
                  rcfg: RasterConfig, ocfg: OptConfig, mesh: Optional[Mesh] = None,
                  update_stats: bool = True, variant: str = "beam"):
    """One optimization step over the global batch (the mean loss):
    (new TrainState, StepMetrics). `frames` is this rank's share, stacked;
    every rank of the data axis must hold as many frames. `mesh` defaults to
    the one-process 1x1 mesh."""
    mesh = mesh if mesh is not None else make_mesh()
    flat, worst = local_sums(state, frames, bg, mcfg, rcfg, ocfg, update_stats, variant)
    # one fused all-reduce: every gradient leaf, the statistics, the losses;
    # the worst counts are the largest over every frame of the batch (the
    # JAX package takes each device's first frame, one frame per device in
    # its tests)
    flat = all_reduce_sum(flat, mesh.data_group)
    worst = all_reduce_max(worst, mesh.data_group)
    return apply_sums(state, flat, worst, frames.gt_image.shape[0] * mesh.data, ocfg,
                      update_stats)


def make_dp_trainer(mesh: Mesh, mcfg: ModelConfig, rcfg: RasterConfig, ocfg: OptConfig,
                    bg: torch.Tensor, update_stats: bool = True, variant: str = "beam"):
    """fn(state, stacked local frames) -> (state, metrics): `dp_train_step`
    bound to its configuration and mesh."""
    return partial(dp_train_step, bg=bg, mcfg=mcfg, rcfg=rcfg, ocfg=ocfg, mesh=mesh,
                   update_stats=update_stats, variant=variant)


@dataclass
class DPTrainer(Trainer):
    """The data-parallel Trainer: the same interface (step / densify /
    render), but `step` takes this rank's stacked frames. One process (the
    CLI's --data_parallel 1 --dp_batch B) or a fleet (`parallel/runtime.py`)
    run the same step; only the mesh differs."""

    mesh: Optional[Mesh] = None

    def step(self, state: TrainState, frames: LidarFrame, iteration: int):
        collect = self.ocfg.start_stat < iteration < self.ocfg.update_until
        return dp_train_step(state, frames, self.bg, self.mcfg, self.rcfg, self.ocfg,
                             mesh=self.mesh, update_stats=collect, variant=self.variant)
