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
  * one small all-reduce (max) of the counts: n_visible of each rank's
    first frame, n_dropped and n_overflow of any frame (JAX's `pmax` of
    `sum(visible_b[0])`, `max(dropped_b)`, `max(overflow_b)`);
  * `apply_step` (`train/trainer.py`), which `train_step` ends in too:
    Adam, and the statistics added, so B frames count B times, as running
    the single-frame loop B times would.

`local_sums` (the frames in turn) and `apply_sums` (the division and the
update) are the two halves around the collectives. On a card `DPTrainer`
runs each half as a CUDA graph (`dp_programs`), the port's counterpart of
JAX's jitted, donated `make_dp_trainer`, with the collectives eager between
them; `DPTrainer(graphed=False)` runs `dp_train_step` eagerly.

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
from ..train.graphs import StaticProgram
from ..train.losses import LossTerms
from ..train.optim import tree_leaves, tree_unflatten
from ..train.trainer import (StepMetrics, Trainer, TrainState, apply_step, commit_into,
                             frame_stats, loss_and_grads)
from .collectives import all_reduce_max, all_reduce_sum
from .mesh import Mesh, make_mesh


def flat_sizes(state: TrainState, update_stats: bool) -> list:
    """The lengths of the flat buffer's pieces: every gradient leaf, the
    four statistics when `update_stats`, the loss terms."""
    accums = [state.opacity_accum, state.anchor_demon, state.offset_grad_accum,
              state.offset_denom] if update_stats else []
    return ([x.numel() for x in tree_leaves(state.params) + accums]
            + [len(LossTerms._fields)])


def _frame_sums(state: TrainState, frame: LidarFrame, bg, mcfg: ModelConfig,
                rcfg: RasterConfig, ocfg: OptConfig, update_stats: bool, variant: str):
    """One frame's (gradient leaves, statistics or None, loss terms [6],
    [n_visible, n_dropped, n_overflow]); its render's tensors are freed on
    return, so the next frame can reuse their memory."""
    (out, ng, anchor_vis, lt), g, proxy_grad = loss_and_grads(
        state, frame, bg, mcfg, rcfg, ocfg, variant)
    stats = frame_stats(state, out, ng, anchor_vis, proxy_grad) if update_stats else None
    counts = torch.stack([out.visible.sum().to(torch.int64), out.n_dropped.to(torch.int64),
                          out.n_overflow.to(torch.int64)])
    return (tree_leaves(g), stats, torch.stack([x.detach().to(torch.float32) for x in lt]),
            counts)


@torch.no_grad()
def local_sums(state: TrainState, frames: LidarFrame, bg, mcfg: ModelConfig,
               rcfg: RasterConfig, ocfg: OptConfig, update_stats: bool = True,
               variant: str = "beam"):
    """This rank's frames in turn: (flat [every gradient leaf, the four
    statistics when `update_stats`, the loss terms], each summed over the
    frames in order; worst [n_visible of the first frame, the largest
    n_dropped and n_overflow of any frame], as JAX's `dp_train_step` reads
    them). `apply_sums` reads the flat buffer once it is summed over the
    data axis."""
    grads = stats = terms = None
    counts = []
    for i in range(frames.gt_image.shape[0]):
        g, s, t, c = _frame_sums(state, index_frame(frames, i), bg, mcfg, rcfg, ocfg,
                                 update_stats, variant)
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        if update_stats:
            stats = s if stats is None else [a + b for a, b in zip(stats, s)]
        terms = t if terms is None else terms + t
        counts.append(c)
    counts = torch.stack(counts)
    worst = torch.cat([counts[0, :1], counts[:, 1:].amax(0)])
    return torch.cat([x.reshape(-1) for x in grads + (stats or []) + [terms]]), worst


@torch.no_grad()
def apply_sums(state: TrainState, flat: torch.Tensor, worst: torch.Tensor, B: int,
               ocfg: OptConfig, update_stats: bool = True):
    """The step from `local_sums`' buffers summed (flat) and maxed (worst)
    over the global batch of B frames: the gradients and losses divided by
    B, then `apply_step`. (new TrainState, StepMetrics)."""
    leaves = tree_leaves(state.params)
    pieces = torch.split(flat, flat_sizes(state, update_stats))
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
    the one-process 1x1 mesh. The input state is left as it is."""
    mesh = mesh if mesh is not None else make_mesh()
    flat, worst = local_sums(state, frames, bg, mcfg, rcfg, ocfg, update_stats, variant)
    # one fused all-reduce: every gradient leaf, the statistics, the losses;
    # the counts maxed over the data axis (JAX's pmax)
    all_reduce_sum(flat, mesh.data_group)
    all_reduce_max(worst, mesh.data_group)
    return apply_sums(state, flat, worst, frames.gt_image.shape[0] * mesh.data, ocfg,
                      update_stats)


def dp_programs(state: TrainState, frames: LidarFrame, update_stats: bool, pool, *, bg,
                mcfg: ModelConfig, rcfg: RasterConfig, ocfg: OptConfig,
                mesh: Optional[Mesh], variant: str):
    """`dp_train_step` over the static state and stacked frames as two
    static programs (`train/graphs.py`) around its collectives, for
    `StepGraphs`: A, `local_sums` written into the static `flat` and `worst`
    buffers; then, eagerly, the all-reduces in place on those buffers (the
    identity at world size 1, through pinned host memory on gloo, on the
    card on nccl); then B, `apply_sums` committing the new state into the
    static state. No collective runs inside a capture or its warm-up, so the
    ranks' collective calls stay in lockstep. Returns the function that runs
    the three and returns B's metrics."""
    mesh = mesh if mesh is not None else make_mesh()
    dev = state.valid.device
    flat = torch.empty((sum(flat_sizes(state, update_stats)),), dtype=torch.float32,
                       device=dev)
    worst = torch.empty((3,), dtype=torch.int64, device=dev)
    B = frames.gt_image.shape[0] * mesh.data

    def local():
        return local_sums(state, frames, bg, mcfg, rcfg, ocfg, update_stats, variant)

    def into_buffers(out):
        flat.copy_(out[0])
        worst.copy_(out[1])

    def apply():
        return apply_sums(state, flat, worst, B, ocfg, update_stats)

    a = StaticProgram(local, into_buffers, dev, pool)
    b = StaticProgram(apply, commit_into(state), dev, pool)

    def run():
        a.run()
        all_reduce_sum(flat, mesh.data_group)
        all_reduce_max(worst, mesh.data_group)
        return b.run()

    return run


def make_dp_trainer(mesh: Mesh, mcfg: ModelConfig, rcfg: RasterConfig, ocfg: OptConfig,
                    bg: torch.Tensor, update_stats: bool = True, variant: str = "beam"):
    """fn(state, stacked local frames) -> (state, metrics): the data-parallel
    step bound to its configuration, mesh and statistics mode, as a
    `DPTrainer` runs it (on a card its programs replay and the state is
    donated)."""
    trainer = DPTrainer(mcfg=mcfg, ocfg=ocfg, rcfg=rcfg, bg=bg, variant=variant, mesh=mesh)
    return partial(trainer.run_step, update_stats=update_stats)


@dataclass
class DPTrainer(Trainer):
    """The data-parallel Trainer: the same interface (step / densify /
    render), but `step` takes this rank's stacked frames. One process (the
    CLI's --data_parallel 1 --dp_batch B) or a fleet (`parallel/runtime.py`)
    run the same step; only the mesh differs. `graphed` and donation as
    `Trainer`'s: on a card `step` replays `dp_programs` (the counterpart of
    JAX's jitted, donated `make_dp_trainer`), `graphed=False` runs
    `dp_train_step` eagerly (the witness)."""

    mesh: Optional[Mesh] = None

    def step_fns(self):
        kw = dict(bg=self.bg, mcfg=self.mcfg, rcfg=self.rcfg, ocfg=self.ocfg,
                  mesh=self.mesh, variant=self.variant)
        return partial(dp_train_step, **kw), partial(dp_programs, **kw)
