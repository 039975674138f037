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

The kernels' launch counters (`ops/composite_kernel.py`,
`ops/surfel_kernel.py`) move when a wrapper runs, which in a graph is at
capture only. A program records the counters' change over its capture and
adds it at every replay, so each run counts the launches it replays. The
warm-up's launches are the capture's cost, as a compile is JAX's, and are
not counted.

`RenderGraphs` is the forward render as such programs: one per (params,
valid) identity and pixel-mask key, with static frame buffers that each
call copies the frame into.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import ModelConfig, RasterConfig
from ..lidar.frames import LidarFrame
from ..models.field import render_fn
from ..ops import composite_kernel, surfel_kernel
from .optim import tree_leaves

WARMUP = 2                     # eager warm-up runs before a capture
COUNTERS = ("launches", "bwd_launches", "windows_launches", "windows_bwd_launches")
_COUNTED = (composite_kernel, surfel_kernel)
FRAME_FIELDS = ("w2s_rot", "w2s_trans", "center", "beams", "gt_image", "uid", "pixel_mask")


def read_counters() -> tuple:
    """The kernel launch counters of both composite modules, in order."""
    return tuple(getattr(m, n) for m in _COUNTED for n in COUNTERS)


def _write_counters(values) -> None:
    it = iter(values)
    for m in _COUNTED:
        for n in COUNTERS:
            setattr(m, n, next(it))


def use_graphs(graphed: Optional[bool], device: torch.device) -> bool:
    """Whether a program on `device` runs as a static program: `graphed`,
    or where it is None, whether the device is a card."""
    return device.type == "cuda" if graphed is None else graphed


def clone_outputs(out):
    """A NamedTuple of tensors (or None) with each tensor cloned."""
    return type(out)(*(None if x is None else x.clone() for x in out))


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
        self.delta = (0,) * len(read_counters())
        if device.type == "cuda":
            self._capture(device, pool)

    def _capture(self, device: torch.device, pool) -> None:
        before = read_counters()
        try:
            ambient = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(ambient)
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    self.compute()
            ambient.wait_stream(side)
            start = read_counters()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.device(device), torch.cuda.graph(graph, pool=pool):
                self.outputs = self.commit(self.compute())
            self.delta = tuple(b - a for a, b in zip(start, read_counters()))
        finally:
            _write_counters(before)
        self.graph = graph

    def run(self):
        if self.graph is None:
            return self.commit(self.compute())
        self.graph.replay()
        _write_counters(a + d for a, d in zip(read_counters(), self.delta))
        return self.outputs


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
    """The forward render of a variant (`models/field.py` `render_fn`) as
    static programs: one per (params, valid) identity and pixel-mask key,
    whose static frame buffers each call copies the frame into. A call
    returns clones of the graph's outputs. The graph reads params and valid
    where they lie, so a state updated in place (a graphed `Trainer.step`'s)
    renders its new values without a new capture; a program for other
    tensors replaces it. `graphed` as `use_graphs` reads it: False (or
    None on the CPU) renders eagerly."""

    def __init__(self, variant: str, mcfg: ModelConfig, rcfg: RasterConfig,
                 bg: torch.Tensor, graphed: Optional[bool] = None, pool=None):
        self.render = render_fn(variant)
        self.mcfg, self.rcfg, self.bg = mcfg, rcfg, bg
        self.graphed, self.pool = graphed, pool
        self.programs: dict = {}

    def __call__(self, params: dict, valid: torch.Tensor, frame: LidarFrame):
        if not use_graphs(self.graphed, valid.device):
            return self.render(params, valid, frame, self.mcfg, self.rcfg, self.bg)[0]
        key = frame.pixel_mask is None
        inputs = tree_leaves(params) + [valid]
        entry = self.programs.get(key)
        if (entry is None or len(entry[0]) != len(inputs)
                or any(a is not b for a, b in zip(entry[0], inputs))
                or entry[1] != frame_layout(frame)):
            self.programs.pop(key, None)
            entry = self._program(inputs, params, valid, frame)
            self.programs[key] = entry
        copy_frame(entry[2], frame)
        return clone_outputs(entry[3].run())

    def _program(self, inputs, params, valid, frame):
        # the closure holds what it reads, not self: no reference cycle
        static = frame_like(frame)
        render, mcfg, rcfg, bg = self.render, self.mcfg, self.rcfg, self.bg

        @torch.no_grad()
        def compute():
            return render(params, valid, static, mcfg, rcfg, bg)[0]

        if self.pool is None and valid.device.type == "cuda":
            self.pool = torch.cuda.graph_pool_handle()
        prog = StaticProgram(compute, lambda out: out, valid.device, self.pool)
        return inputs, frame_layout(frame), static, prog
