"""CUDA graphs of the training step and the render: the port's counterpart
of the JAX package's compiled programs, `jax.jit(train_step,
donate_argnums=(0,))` (`lidargs_tpu/train/trainer.py`) and the CLI's jitted
renders (`lidargs_tpu/train/cli.py`).

A `StaticProgram` is a function of static buffers, tensors that live as
long as the program. `compute()` reads them and returns its outputs;
`commit(outputs)` writes what must persist into static buffers (the
donated training state) and returns what the caller gets. On a CUDA device
the program follows PyTorch's whole-network capture recipe: `compute` runs
eagerly on a side stream a few times (its results dropped, so no static
buffer moves), then `commit(compute())` is captured into one
`torch.cuda.CUDAGraph`, and `run()` replays it. The hand-written kernels
(K1-K8) launch on the current stream (`utils/cuda_build.py`), so the graph
records their launches like any other. On the CPU, which has no graphs,
`run()` calls `commit(compute())`: the same bookkeeping, which the CPU
tests drive. A capture or a replay that fails raises; nothing falls back to
eager.

Graphs of one owner share a memory pool (`torch.cuda.graph_pool_handle`),
since they never run at once. A later capture may then reuse memory that an
earlier graph's intermediates used, so a graph's outputs are valid only
until another graph of the pool replays: every caller here clones them
right after the replay (`clone_outputs`).

The launcher's count of the kernels' launches (`utils/cuda_build.py`
`launches`) moves when a wrapper launches, which in a graph is at capture
only. A program keeps the count's change over its capture and adds it at
every replay, so each run counts the launches it replays. The warm-up's
launches are the capture's cost, as a compile is JAX's, and are not
counted; a capture that fails leaves the count as it found it.

`RenderGraphs` is the forward render as such programs: one per (params,
valid) identity, pixel-mask key and live extent, with static frame buffers
that each call copies the frame into. Given a ray-drop refiner
(`refine(color, depth) -> color`, e.g. LiDAR4D's UNet through
`models/raydrop.py` `refine_color`), the program applies it after the
field's render (`refine_frame`), so a refined frame is one replay too. A
capture runs with cuDNN's benchmark mode off (`cudnn_heuristics`): the
refiner's convolutions take the algorithm cuDNN's heuristics give for their
shape, and no autotuning run is recorded into a graph.

The live extent (`LiveExtent`): the anchor table is padded to its capacity
C and densify grows into its first free rows, so every live row lies below
the high-water mark `1 + max{i : valid[i]}`. A program's front runs on the
rows [0, B) (`models/field.py` `anchor_rows`), where B rounds the mark up to
a sixteenth of C (`extent_rule`): the rows above are padding, masked
everywhere, and cost the decode, projection and pack as much as a live row.
The mark is read on the host (one synchronize) only when the program is
given a `valid` it has not read, or one written in place since.

The recorder's stamps (`utils/profiling.py` `telemetry`) inside a program
are captured with it when the capture runs inside a Trainer's scope; the
warm-up runs stamp nothing. Each program made is counted
(`telemetry.captures`) under a host span `capture`, and the extent of the
last program built is `telemetry.extent`.

A frame's front is one kernel (`models/field.py` `render_frame_packed`, F1
on a card, and `render_surfel_packed`, F2) where the kernels take the
layout (`frame_render`, `ops/front_kernel.py` `takes`). Each render
program made with either on a card, and each eager frame rendered with
either on a card, is counted (`telemetry.fused_fronts`); on the CPU their
front is the plain version.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Callable, Optional

import torch

from ..config import ModelConfig, RasterConfig
from ..lidar.frames import LidarFrame
from ..models.field import PACKED_FRAMES, anchor_rows, frame_render, render_fn
from ..utils import cuda_build
from ..utils.profiling import telemetry
from .optim import tree_leaves

WARMUP = 2                     # eager warm-up runs before a capture
FRAME_FIELDS = ("w2s_rot", "w2s_trans", "center", "beams", "gt_image", "uid", "pixel_mask")
QUANTA = 16                    # the live extent moves in steps of a sixteenth of the capacity
DROP_P = 0.5                   # a pixel whose ray-drop probability exceeds this is dropped


def use_graphs(graphed: Optional[bool], device: torch.device) -> bool:
    """Whether a program on `device` runs as a static program: `graphed`,
    or where it is None, whether the device is a card."""
    return device.type == "cuda" if graphed is None else graphed


def clone_outputs(out):
    """A NamedTuple of tensors (or None) with each tensor cloned."""
    return type(out)(*(None if x is None else x.clone() for x in out))


@contextlib.contextmanager
def cudnn_heuristics():
    """cuDNN's benchmark mode off while the block runs (the previous flag
    after): each convolution takes the algorithm the heuristics give for
    its shape, so a capture records no autotuning run. A forward needs no
    more (`models/raydrop.py` `deterministic_convs` is for the UNet's
    training): cuDNN names non-deterministic algorithms among the
    backwards only, so one forward algorithm gives the same bits at every
    replay."""
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark
    cudnn.benchmark = False
    try:
        yield
    finally:
        cudnn.benchmark = saved


_WARMUP_STREAMS: dict = {}


def warmup_stream(device: torch.device):
    """The one side stream of `device` that every capture's warm-up runs
    on: the caching allocator keeps a freed block for the stream it was
    used on, so a new stream per capture would leave each warm-up's blocks
    reserved and never used again."""
    key = (device, torch.cuda.Stream)
    if key not in _WARMUP_STREAMS:
        _WARMUP_STREAMS[key] = torch.cuda.Stream(device)
    return _WARMUP_STREAMS[key]


class StaticProgram:
    """`commit(compute())` over static buffers: one CUDA graph on `device`,
    captured in `pool` after WARMUP eager runs of `compute` on a side
    stream, or the two functions called on the CPU. `run()` returns what
    `commit` returned, the same tensors at every replay."""

    def __init__(self, compute: Callable, commit: Callable, device: torch.device,
                 pool=None):
        self.compute, self.commit = compute, commit
        self.graph = None
        self.outputs = None
        self.delta = collections.Counter()      # the launches a replay counts
        with telemetry.span("capture"):
            if device.type == "cuda":
                self._capture(device, pool)
        telemetry.captures += 1

    def _capture(self, device: torch.device, pool) -> None:
        before = cuda_build.launches.copy()
        try:
            ambient = torch.cuda.current_stream(device)
            side = warmup_stream(device)
            side.wait_stream(ambient)
            telemetry.warming = True
            try:
                with torch.cuda.stream(side), cudnn_heuristics():
                    for _ in range(WARMUP):
                        self.compute()
            finally:
                telemetry.warming = False
            ambient.wait_stream(side)
            start = cuda_build.launches.copy()
            graph = torch.cuda.CUDAGraph()
            with (torch.cuda.device(device), cudnn_heuristics(),
                  torch.cuda.graph(graph, pool=pool)):
                self.outputs = self.commit(self.compute())
            self.delta = cuda_build.launches - start
        finally:
            cuda_build.launches.clear()
            cuda_build.launches.update(before)
        self.graph = graph

    def run(self):
        if self.graph is None:
            return self.commit(self.compute())
        self.graph.replay()
        cuda_build.launches.update(self.delta)
        return self.outputs


def live_mark(valid: torch.Tensor) -> int:
    """1 + the last live row of `valid` (0 when none are): a host read."""
    rows = torch.nonzero(valid)
    return int(rows[-1, 0]) + 1 if rows.shape[0] else 0


def extent_rule(mark: int, C: int, B: int = 0) -> int:
    """The rows [0, B') a front runs on, for the mark `mark` of a table of
    capacity C whose current extent is B (0: none yet). B' is B while the
    mark stays within it (an extent never shrinks); else the mark rounded
    up to q = C / QUANTA rows (at least q), with one q more of headroom
    when it grows past a current B, so that a growing field recaptures
    rarely; never above C, and C once the mark is within q of it."""
    if B and mark <= B:
        return B
    q = max(C // QUANTA, 1)
    return min(C, q * max(1, -(-mark // q)) + (q if B else 0))


class LiveExtent:
    """The live extent of one anchor table (`extent_rule`), read from its
    `valid` on the host only when `valid` is another tensor, or the same
    one written in place (its version moved), than the one last read or
    held. A table of another capacity starts afresh."""

    def __init__(self):
        self.B, self.C = 0, None
        self.valid, self.version = None, None

    def __call__(self, valid: torch.Tensor) -> int:
        if not self.knows(valid):
            if valid.shape[0] != self.C:
                self.B, self.C = 0, valid.shape[0]
            self.B = extent_rule(live_mark(valid), self.C, self.B)
            self.hold(valid)
        return self.B

    def knows(self, valid: torch.Tensor) -> bool:
        """Whether `valid` is the tensor last read or held, as it was."""
        return valid is self.valid and valid._version == self.version

    def hold(self, valid: torch.Tensor) -> None:
        """`valid` now holds what was last read (a copy of it): no read."""
        self.valid, self.version = valid, valid._version


def frame_like(frame: LidarFrame) -> LidarFrame:
    """Static frame buffers shaped like `frame` (the mask only if it has
    one), holding its values."""
    return LidarFrame(*(None if getattr(frame, n) is None else getattr(frame, n).clone()
                        for n in FRAME_FIELDS))


def copy_frame(dst: LidarFrame, src: LidarFrame) -> None:
    """Copy `src`'s tensors into the static frame `dst` (same layout)."""
    for n in FRAME_FIELDS:
        d, s = getattr(dst, n), getattr(src, n)
        if d is not None and d is not s:
            d.copy_(s)


def layout(tensors) -> tuple:
    """What a graph's buffers must match: each tensor's shape, type and
    device (None stays None)."""
    return tuple(None if t is None else (tuple(t.shape), t.dtype, t.device) for t in tensors)


def frame_layout(frame: LidarFrame) -> tuple:
    return layout(getattr(frame, n) for n in FRAME_FIELDS)


class RenderGraphs:
    """The forward render of a variant (`models/field.py` `render_fn`) on
    the anchor rows [0, B) as static programs: one per (params, valid)
    identity, pixel-mask key and B, whose static frame buffers each call
    copies the frame into. A call returns clones of the graph's outputs.
    The graph reads params and valid where they lie, so a state updated in
    place (a graphed `Trainer.step`'s) renders its new values without a new
    capture; a program for other tensors or another B replaces it. B is the
    `extent` given (`Trainer.render` gives its step's, whose own static
    `valid` a densify rewrites in place), else the live extent of `valid`
    (`LiveExtent`). `graphed` as `use_graphs` reads it: False (or None on
    the CPU) renders eagerly, on the same rows. The frame is
    `frame_render`'s for the params' layout: the front as one kernel where
    it takes the layout. `refine(color, depth) ->
    color`, where given, replaces each frame's [intensity, raydrop] inside
    the program (`refine_frame`); without it the program is the field's
    render alone."""

    def __init__(self, variant: str, mcfg: ModelConfig, rcfg: RasterConfig,
                 bg: torch.Tensor, graphed: Optional[bool] = None, pool=None,
                 refine: Optional[Callable] = None):
        render_fn(variant)                     # refuses an unknown variant
        self.variant = variant
        self.mcfg, self.rcfg, self.bg = mcfg, rcfg, bg
        self.graphed, self.pool = graphed, pool
        self.refine = refine
        self.extent = LiveExtent()
        self.programs: dict = {}

    def __call__(self, params: dict, valid: torch.Tensor, frame: LidarFrame,
                 extent: Optional[int] = None):
        B = self.extent(valid) if extent is None else extent
        if not use_graphs(self.graphed, valid.device):
            render = self.render_for(params, valid.device)
            out = stamped_render(render, *anchor_rows(params, valid, B), frame, self.mcfg,
                                 self.rcfg, self.bg)
            return (end_frame(out) if self.refine is None
                    else end_refined(refine_frame(self.refine, out)))
        key = frame.pixel_mask is None
        inputs = tree_leaves(params) + [valid]
        entry = self.programs.get(key)
        if (entry is None or len(entry[0]) != len(inputs)
                or any(a is not b for a, b in zip(entry[0], inputs))
                or entry[1] != frame_layout(frame) or entry[4] != B):
            # the program replaced is dropped after the new capture: a pool
            # that no graph holds takes no capture
            entry = self.programs[key] = self._program(inputs, params, valid, frame, B)
        with telemetry.span("frame_copy"):
            copy_frame(entry[2], frame)
        with telemetry.span("replay"):
            out = entry[3].run()
        with telemetry.span("clone_outputs"):
            return clone_outputs(out)

    def render_for(self, params: dict, device: torch.device):
        """The frame's render for `params`' layout (`frame_render`),
        counted in `telemetry.fused_fronts` where its front runs as one
        kernel, F1 or F2 on a card: once a program, or once an eager
        frame."""
        render = frame_render(self.variant, params, self.mcfg, self.rcfg)
        if render in PACKED_FRAMES.values() and device.type == "cuda":
            telemetry.fused_fronts += 1
        return render

    def _program(self, inputs, params, valid, frame, B: int):
        # the closures hold what they read, not self: no reference cycle
        static = frame_like(frame)
        render = self.render_for(params, valid.device)
        mcfg, rcfg, bg, refine = self.mcfg, self.rcfg, self.bg, self.refine
        rows = anchor_rows(params, valid, B)

        @torch.no_grad()
        def compute():
            return stamped_render(render, *rows, static, mcfg, rcfg, bg)

        commit = end_frame
        if refine is not None:
            field, commit = compute, end_refined
            compute = lambda: refine_frame(refine, field())   # noqa: E731
        if self.pool is None and valid.device.type == "cuda":
            self.pool = torch.cuda.graph_pool_handle()
        telemetry.extent = B
        prog = StaticProgram(compute, commit, valid.device, self.pool)
        return inputs, frame_layout(frame), static, prog, B


def stamped_render(render, params, valid, frame, mcfg, rcfg, bg):
    """`render`'s output after the frame's begin stamp (`utils/profiling.py`
    `telemetry`: inside `Trainer.render` only)."""
    telemetry.stamp("begin", valid)
    return render(params, valid, frame, mcfg, rcfg, bg)[0]


def end_frame(out):
    """The frame's end stamp, with its overflow and dropped counts."""
    telemetry.stamp("end", out.depth, (out.n_overflow, out.n_dropped), first="n_overflow")
    return out


@torch.no_grad()
def refine_frame(refine: Callable, out):
    """(`out` with its [intensity, raydrop] replaced by `refine(color,
    depth)`'s, the pixels whose drop decision (p > DROP_P) the refiner
    changed, an int64 scalar): after the refine stamp, which carries the
    field's overflow and dropped counts (the end stamp's of a plain frame)."""
    telemetry.stamp("refine", out.depth, (out.n_overflow, out.n_dropped), first="n_overflow")
    color = refine(out.color, out.depth)
    flipped = ((color[1] > DROP_P) != (out.color[1] > DROP_P)).sum()
    return out._replace(color=color), flipped


def end_refined(refined):
    """A refined frame's end stamp, with its `n_flipped`; the frame."""
    out, flipped = refined
    telemetry.stamp("end", out.depth, (flipped,), first="n_flipped")
    return out
