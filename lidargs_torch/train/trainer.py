"""Training step and its orchestration: render -> 5-term loss -> backward -> Adam,
plus the densification statistics.

Counterpart of `lidargs_tpu/train/trainer.py`, for both variants.
`train_step` is eager PyTorch. The beam variant composites through kernels
K1 and K2 on the card (`ops/composite_kernel.py`) and projects through its
hand VJP; the surfel (2DGS) variant (`variant="surfel"`) composites through
K5 and K6 (`ops/surfel_kernel.py`), differentiates its preprocess with
autograd and adds the distortion and normal-consistency regularizers, each
gated on the step. Densify and prune run between steps
(`models/densify.py`), eagerly.

On a card, `Trainer.step` replays `train_step` as one CUDA graph with the
state donated (`StepGraphs`, the counterpart of JAX's `jax.jit(train_step,
donate_argnums=(0,))`), and `Trainer.render` replays the render as one
(`train/graphs.py`). `Trainer(graphed=False)` runs both eagerly.
`DPTrainer` (`parallel/shard.py`) shares the dispatch and `StepGraphs`
with programs of its own (`step_fns`).

The densification signal: a zeros proxy [C, k, 3] is added to the
unit-sphere means after the projection (beam) or to the decoded world means
(surfel), and the norm of its gradient is accumulated per decoded gaussian.

Parameters that the loss does not reach (a head the configuration does not
use) get a zero gradient, as in the JAX package's gradient pytree, so their
Adam moments still decay.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from dataclasses import field as dc_field
from typing import NamedTuple, Optional

import torch

from ..config import ModelConfig, OptConfig, RasterConfig
from ..lidar.frames import LidarFrame
from ..models.field import AnchorField, render_fn
from .graphs import (RenderGraphs, StaticProgram, copy_frame, frame_layout, frame_like,
                     layout, use_graphs)
from .losses import LossTerms, lidar_losses, normal_consistency_loss
from .optim import AdamState, adam_update, init_adam, lr_schedules, tree_leaves, tree_unflatten


class TrainState(NamedTuple):
    params: dict
    opt: AdamState
    valid: torch.Tensor              # [C] anchor liveness
    step: torch.Tensor               # [] int32
    # densification statistics (capacity-padded)
    opacity_accum: torch.Tensor      # [C]
    anchor_demon: torch.Tensor       # [C]
    offset_grad_accum: torch.Tensor  # [C*k]
    offset_denom: torch.Tensor       # [C*k]


def init_train_state(field: AnchorField, mcfg: ModelConfig) -> TrainState:
    C = field.params["anchor"].shape[0]
    k = mcfg.n_offsets
    f32 = dict(dtype=torch.float32, device=field.valid.device)
    return TrainState(
        params=field.params,
        opt=init_adam(field.params),
        valid=field.valid,
        step=torch.zeros((), dtype=torch.int32, device=field.valid.device),
        opacity_accum=torch.zeros((C,), **f32),
        anchor_demon=torch.zeros((C,), **f32),
        offset_grad_accum=torch.zeros((C * k,), **f32),
        offset_denom=torch.zeros((C * k,), **f32),
    )


def make_optimizer(ocfg: OptConfig):
    """The per-group learning-rate schedules that `adam_update` reads."""
    return lr_schedules(ocfg)


class StepMetrics(NamedTuple):
    loss: LossTerms
    n_anchors: torch.Tensor
    n_visible: torch.Tensor
    n_dropped: torch.Tensor
    n_overflow: torch.Tensor


def frame_loss(params, proxy, valid, step, frame: LidarFrame, bg,
               mcfg: ModelConfig, rcfg: RasterConfig, ocfg: OptConfig,
               variant: str = "beam"):
    """Per-frame render + 5-term loss: (total, (RenderOut or SurfelOut,
    NeuralGaussians, anchor_visible, LossTerms)). `proxy` is the zeros
    densification probe added to the unit-sphere means (surfel: the world
    means). The surfel variant adds the distortion and normal-consistency
    terms from `ocfg.dist_from` and `ocfg.normal_from` on."""
    out, ng, anchor_vis = render_fn(variant)(params, valid, frame, mcfg, rcfg, bg, proxy)
    lt = lidar_losses(
        out.color, out.depth, frame.gt_image,
        ng.scaling[..., :2] if variant == "surfel" else ng.scaling, ng.mask,
        lambda_dssim=ocfg.lambda_dssim,
        raydrop_lambda=ocfg.raydrop_lambda,
        scale_reg=ocfg.scale_reg,
        grad_clip_x=ocfg.grad_clip_x,
        pixel_mask=frame.pixel_mask,
    )
    if variant == "surfel":
        # gated on the step tensor, not on a host copy of it (no sync)
        dist_w = torch.where(step >= ocfg.dist_from, ocfg.dist_lambda, 0.0)
        norm_w = torch.where(step >= ocfg.normal_from, ocfg.normal_lambda, 0.0)
        hit = frame.gt_image[0]
        if frame.pixel_mask is not None:
            hit = hit * frame.pixel_mask
        dist_loss = (out.distortion * hit).sum() / hit.sum().clamp_min(1.0)
        nc_loss = normal_consistency_loss(out.normal, out.depth, frame.beams, frame.W, hit)
        lt = lt._replace(total=lt.total + dist_w * dist_loss + norm_w * nc_loss)
    if ocfg.overflow_lambda > 0:
        # capacity-pressure regularizer: truncated instances per decoded
        # gaussian (a constant) times the mean positive opacity, so its
        # gradient pushes every selected opacity down while tiles overflow
        sel = ng.sel_mask.to(torch.float32)
        n_sel = sel.sum().clamp_min(1.0)
        pressure = (out.n_overflow.to(torch.float32) / n_sel).detach()
        op_mass = torch.where(ng.sel_mask, ng.neural_opacity,
                              torch.zeros_like(ng.neural_opacity)).sum() / n_sel
        lt = lt._replace(total=lt.total + ocfg.overflow_lambda * pressure * op_mass)
    return lt.total, (out, ng, anchor_vis, lt)


def loss_and_grads(state: TrainState, frame: LidarFrame, bg, mcfg: ModelConfig,
                   rcfg: RasterConfig, ocfg: OptConfig, variant: str = "beam"):
    """The loss of one frame and its gradients: (aux of `frame_loss`, grads
    shaped like `state.params`, proxy gradient [C, k, 3]). A parameter the
    loss does not reach gets zeros."""
    C = state.params["anchor"].shape[0]
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(state.params)]
    params = tree_unflatten(state.params, leaves)
    proxy = torch.zeros((C, mcfg.n_offsets, 3), dtype=torch.float32,
                        device=state.valid.device, requires_grad=True)
    with torch.enable_grad():
        total, aux = frame_loss(params, proxy, state.valid, state.step, frame,
                                bg, mcfg, rcfg, ocfg, variant)
        gs = torch.autograd.grad(total, leaves + [proxy], allow_unused=True)
    gs = [torch.zeros_like(x) if gx is None else gx for gx, x in zip(gs, leaves + [proxy])]
    return aux, tree_unflatten(state.params, gs[:-1]), gs[-1]


def frame_stats(state: TrainState, out, ng, anchor_vis, proxy_grad) -> list:
    """One frame's densification statistics, in TrainState's order:
    [opacity [C], visits [C], proxy-gradient norms [C*k], their count
    [C*k]]."""
    vis_anchor = anchor_vis & state.valid                            # [C]
    op = ng.neural_opacity.detach().clamp_min(0.0)                  # [C,k]
    zero = torch.zeros((), dtype=torch.float32, device=op.device)
    stat_mask = ng.sel_mask.reshape(-1) & out.visible.reshape(-1)   # [C*k]
    gnorm = torch.linalg.vector_norm(proxy_grad, dim=-1).reshape(-1)
    return [torch.where(vis_anchor, op.sum(1), zero), vis_anchor.to(torch.float32),
            torch.where(stat_mask, gnorm, zero), stat_mask.to(torch.float32)]


@torch.no_grad()
def apply_step(state: TrainState, grads: dict, stats: Optional[list],
               ocfg: OptConfig) -> TrainState:
    """Adam on `grads` and the statistics `stats` (`frame_stats`' order;
    None leaves them as they are) added: the next TrainState. The input
    state is left as it is."""
    new_params, new_opt = adam_update(state.params, grads, state.opt,
                                      lr_schedules(ocfg), state.step, ocfg)
    accums = (state.opacity_accum, state.anchor_demon, state.offset_grad_accum,
              state.offset_denom)
    if stats is not None:
        accums = tuple(a + d for a, d in zip(accums, stats))
    return TrainState(new_params, new_opt, state.valid, state.step + 1, *accums)


@torch.no_grad()
def train_step(state: TrainState, frame: LidarFrame, bg, mcfg: ModelConfig,
               rcfg: RasterConfig, ocfg: OptConfig, update_stats: bool = True,
               variant: str = "beam"):
    """One optimization step: (new TrainState, StepMetrics). The input
    state is left as it is."""
    (out, ng, anchor_vis, lt), grads, proxy_grad = loss_and_grads(
        state, frame, bg, mcfg, rcfg, ocfg, variant)
    stats = frame_stats(state, out, ng, anchor_vis, proxy_grad) if update_stats else None
    metrics = StepMetrics(
        loss=LossTerms(*(x.detach() for x in lt)),
        n_anchors=state.valid.sum(),
        n_visible=out.visible.sum(),
        n_dropped=out.n_dropped,
        n_overflow=out.n_overflow,
    )
    return apply_step(state, grads, stats, ocfg), metrics


def state_leaves(state: TrainState) -> list:
    """Every tensor of a TrainState, in a fixed order."""
    return (tree_leaves(state.params) + tree_leaves(state.opt.mu) + tree_leaves(state.opt.nu)
            + [state.opt.count, state.valid, state.step, state.opacity_accum,
               state.anchor_demon, state.offset_grad_accum, state.offset_denom])


def clone_state(state: TrainState) -> TrainState:
    p, o = state.params, state.opt
    clone = lambda t: tree_unflatten(t, [x.clone() for x in tree_leaves(t)])
    return TrainState(clone(p), AdamState(clone(o.mu), clone(o.nu), o.count.clone()),
                      *(x.clone() for x in state[2:]))


def clone_metrics(m: StepMetrics) -> StepMetrics:
    return StepMetrics(LossTerms(*(x.clone() for x in m.loss)),
                       *(x.clone() for x in m[1:]))


def commit_into(state: TrainState):
    """A program's commit for a step over the static state `state`: write
    the new TrainState into it, leaf by leaf (donation), and return the
    metrics."""
    def commit(out):
        new, metrics = out
        for dst, src in zip(state_leaves(state), state_leaves(new)):
            if dst is not src:
                dst.copy_(src)
        return metrics
    return commit


def step_program(step, state: TrainState, frame: LidarFrame, update_stats: bool, pool):
    """`step` (`train_step` with the trainer's fixed arguments) over the
    static state and frame as one StaticProgram: its `run`."""
    # the closures hold the static buffers, not the trainer: no reference
    # cycle keeps a dropped trainer's graphs and pool alive
    def compute():
        return step(state, frame, update_stats=update_stats)

    return StaticProgram(compute, commit_into(state), state.valid.device, pool).run


class StepGraphs:
    """A training step as static programs (`train/graphs.py`): one set per
    (update_stats, frame layout) key, the frame layout saying whether it has
    a pixel mask and how many frames a batch stacks. `build(state, frame,
    update_stats, pool)` makes a key's programs over the static state and
    frame buffers and returns a function that runs them (replays) and
    returns the step's metrics: `step_program` for `train_step`, or the
    data-parallel step's two programs around its collectives
    (`parallel/shard.py` `dp_programs`). All keys share one set of static
    state buffers: the programs write the new TrainState into them
    (donation, as JAX's `donate_argnums=(0,)`), and `run` returns them. A
    state that is not those buffers (the first call's, a densify's, a
    maintain's, a resumed or loaded one) is copied in, leaf by leaf, before
    the replay; a state of another layout (capacity) drops every program and
    is captured anew. The frame is copied into static frame buffers before
    each replay."""

    def __init__(self, build, pool):
        self.build, self.pool = build, pool
        self.state: Optional[TrainState] = None
        self.layout = None
        self.frames: dict = {}
        self.programs: dict = {}

    def run(self, state: TrainState, frame: LidarFrame, update_stats: bool):
        leaves = state_leaves(state)
        lay = layout(leaves)
        if lay != self.layout:
            self.programs.clear()
            self.frames.clear()
            self.state, self.layout = clone_state(state), lay
        else:
            for dst, src in zip(state_leaves(self.state), leaves):
                if dst is not src:
                    dst.copy_(src)
        flay = frame_layout(frame)
        static_frame = self.frames.get(flay)
        if static_frame is None:
            static_frame = self.frames[flay] = frame_like(frame)
        else:
            copy_frame(static_frame, frame)
        run = self.programs.get((update_stats, flay))
        if run is None:
            run = self.programs[(update_stats, flay)] = self.build(
                self.state, static_frame, update_stats, self.pool)
        return self.state, clone_metrics(run())


@dataclass
class Trainer:
    """Host-side orchestration: the step with its statistics rule and the densify
    and maintenance cadence.

    `graphed` picks how `step` and `render` run: None (the default) as CUDA
    graphs on a CUDA state and eagerly on the CPU; False eagerly everywhere
    (the witness the graphs are held against); True as static programs
    everywhere, where on the CPU, which has no graphs, the program's
    function is called in place of a replay (the CPU tests' stand-in). The
    variant and the configs are fixed per Trainer, as JAX's `partial` fixes
    them in its jitted step. A trainer's graphs share one memory pool.

    Donation: a graphed `step` returns the trainer's static state buffers,
    which the next `step` overwrites in place, as JAX's donated arrays are
    reused. A caller that keeps a state that `step` returned across a later
    `step` must clone it (`clone_state`). A state passed in that is not
    those buffers is copied in and left as it is."""

    mcfg: ModelConfig
    ocfg: OptConfig
    rcfg: RasterConfig
    bg: torch.Tensor
    variant: str = "beam"                   # "beam" | "surfel"
    graphed: Optional[bool] = None
    _pool: object = dc_field(default=None, init=False, repr=False, compare=False)
    _steps: Optional[StepGraphs] = dc_field(default=None, init=False, repr=False, compare=False)
    _renders: Optional[RenderGraphs] = dc_field(default=None, init=False, repr=False,
                                             compare=False)

    def graph_pool(self, device: torch.device):
        """The memory pool of this trainer's graphs on `device` (None off
        the card)."""
        if self._pool is None and device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def render(self, params: dict, valid: torch.Tensor, frame: LidarFrame):
        """The forward render of this trainer's variant: RenderOut (beam) or
        SurfelOut (surfel), both with color, depth and occ. Graphed, it
        returns clones of the graph's outputs."""
        if self._renders is None:
            self._renders = RenderGraphs(self.variant, self.mcfg, self.rcfg, self.bg,
                                         self.graphed, self.graph_pool(valid.device))
        return self._renders(params, valid, frame)

    def step(self, state: TrainState, frame: LidarFrame, iteration: int):
        """One step: (TrainState, StepMetrics), the statistics collected
        between `start_stat` and `update_until`. Graphed, the state returned
        is the static buffers (see the class's note on donation)."""
        return self.run_step(state, frame,
                             self.ocfg.start_stat < iteration < self.ocfg.update_until)

    def run_step(self, state: TrainState, frame: LidarFrame, update_stats: bool):
        """`step` with the statistics mode given (JAX's `_step` and
        `_step_nostats`): eager or graphed as `graphed` says."""
        eager, build = self.step_fns()
        if not use_graphs(self.graphed, state.valid.device):
            return eager(state, frame, update_stats=update_stats)
        if self._steps is None:
            self._steps = StepGraphs(build, self.graph_pool(state.valid.device))
        return self._steps.run(state, frame, update_stats)

    def step_fns(self):
        """(the eager step, fn(state, frame, update_stats=...); the function
        that makes its static programs, which `StepGraphs` takes), with this
        trainer's fixed arguments: `train_step` and `step_program`."""
        step = functools.partial(train_step, bg=self.bg, mcfg=self.mcfg, rcfg=self.rcfg,
                                 ocfg=self.ocfg, variant=self.variant)
        return step, functools.partial(step_program, step)

    def densify(self, state: TrainState, generator: Optional[torch.Generator],
                voxel_size: float, draws: Optional[torch.Tensor] = None):
        """Grow and prune at the update_interval cadence: (TrainState,
        DensifyStats). The random keep draws come from `generator`, or are
        given as `draws` [update_depth, C*k]."""
        from ..models.densify import densify_step

        return densify_step(state, self.mcfg, self.ocfg, float(voxel_size),
                            check_interval=self.ocfg.update_interval,
                            generator=generator, draws=draws)

    def should_densify(self, state_n_anchors: int, iteration: int) -> bool:
        o = self.ocfg
        return (
            o.start_stat < iteration < o.update_until
            and state_n_anchors < self.mcfg.max_anchors
            and iteration > o.update_from
            and iteration % o.update_interval == 0
        )

    def should_maintain(self, iteration: int) -> bool:
        """After update_until, keep the prune pass's cov log-scale clamp
        running at the update_interval cadence (OptConfig
        scale_clamp_after_until)."""
        o = self.ocfg
        return (
            o.scale_clamp_after_until
            and iteration >= o.update_until
            and iteration % o.update_interval == 0
        )

    def maintain(self, state: TrainState) -> TrainState:
        return _clamp_cov_scales(state)


@torch.no_grad()
def _clamp_cov_scales(state: TrainState) -> TrainState:
    """The prune pass's clamp on its own: cov log-scales capped at 0.05, on
    the params only (the Adam moments are left as they are)."""
    p = dict(state.params)
    s = p["scaling"]
    p["scaling"] = torch.cat([s[:, :3], s[:, 3:].clamp_max(0.05)], 1)
    return state._replace(params=p)
