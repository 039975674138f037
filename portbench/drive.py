"""The system under test: the port's training loop and re-simulation loop.

Everything here calls `lidargs_torch` the way its users do. Training
follows the CLI's loop (`lidargs_torch/train/cli.py` `main`): frames drawn
as the CLI draws them (a `random.Random(seed)` stack of the train frames,
popped at random, refilled when empty), `Trainer.step` (one CUDA graph on
the card), the loss read to the host every `log_every` iterations, and
`should_densify` / `densify` / `maintain` at the `update_interval`
cadence. Re-simulation is a closed loop of `Trainer.render` (one CUDA graph
on the card) over a trajectory of novel poses, each frame waited for
before the next is asked for.

The port is imported only inside these functions, so the harness's other
modules, and the reference, load without it.
"""
from __future__ import annotations

import contextlib
import math
import random
import time
from typing import Callable, Optional

import numpy as np
import torch

from .scene import Pose

WARM_RENDERS = 3             # renders before the window: the capture and two replays
ADAM_B1 = 0.9                # the port's Adam: its first moment after one step is 0.1 g


def dataclass_from(cls, values: dict, nested=()):
    """`cls(**values)`, a dict value turned into the one of `nested` that
    the field's default is an instance of."""
    import dataclasses

    kw = {}
    defaults = {f.name: f for f in dataclasses.fields(cls)}
    for k, v in values.items():
        f = defaults[k]
        if isinstance(v, dict):
            sub = next(c for c in nested if f.default_factory is not dataclasses.MISSING
                       and isinstance(f.default_factory(), c))
            v = sub(**v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[k] = v
    return cls(**kw)


def port_configs(config: dict):
    """(ModelConfig, RasterConfig, OptConfig) of the port from a
    configuration file's groups."""
    from lidargs_torch.config import LrSchedule, ModelConfig, OptConfig, RasterConfig

    return (dataclass_from(ModelConfig, config["model"]),
            dataclass_from(RasterConfig, config["raster"]),
            dataclass_from(OptConfig, config["opt"], (LrSchedule,)))


def stage_args(stages) -> dict:
    """The port's `Trainer` arguments that the stages give ([(registry.Stage,
    drawn)])."""
    kw: dict = {}
    for stage, drawn in stages:
        args = stage.program(drawn)
        if kw.keys() & args.keys():
            raise ValueError(f"stage {stage.name!r} gives Trainer arguments "
                             f"{sorted(kw.keys() & args.keys())} that another stage gives")
        kw.update(args)
    return kw


def port_frame(pose: Pose, gt: torch.Tensor, beams: torch.Tensor, uid: int):
    from lidargs_torch.lidar.frames import LidarFrame

    return LidarFrame(pose.w2s_rot, pose.w2s_trans, pose.center, beams, gt,
                      torch.full((), uid, dtype=torch.int32, device=gt.device))


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.detach().clone()


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Spans:
    """Named host spans (torch.profiler.record_function) while a trace is
    on, and nothing otherwise."""

    def __init__(self):
        self.on = False

    def __call__(self, name: str):
        return torch.profiler.record_function(name) if self.on else contextlib.nullcontext()


class TrainDrive:
    """The CLI's training loop over the port's `Trainer`, from iteration
    `first_iteration` on. Set-up drives the first `checked_steps`
    iterations and keeps what the check compares: each step's loss, the
    first gradient as Adam's first moment holds it, and the parameters
    after the last of them. A traced window also keeps the field as its
    traced segment starts and the frames drawn in the segment, for the
    counts of the work the segment did (`counted_inputs`)."""

    def __init__(self, cell, seed: int, inputs, dev: torch.device, stages=()):
        from lidargs_torch.models.field import AnchorField
        from lidargs_torch.train.trainer import Trainer, init_train_state

        self.dev = dev
        t = cell.traffic
        self.mcfg, self.rcfg, self.ocfg = port_configs(cell.config)
        self.trainer = Trainer(mcfg=self.mcfg, ocfg=self.ocfg, rcfg=self.rcfg,
                               bg=torch.zeros((self.mcfg.color_channel,), device=dev),
                               variant=cell.config["variant"], **stage_args(stages))
        self.frames = [port_frame(p, gt, inputs.scene.beams, i)
                       for i, (p, gt) in enumerate(inputs.scene.train)]
        self.voxel = inputs.voxel
        self.log_every = t["log_every"]
        self.rng = random.Random(seed)
        self.stack: list = []
        self.densify_gen = torch.Generator(device=dev).manual_seed(seed)
        self.spans = Spans()
        self.drawn: list = []
        state = init_train_state(AnchorField(clone_tree(inputs.params), inputs.valid.clone(),
                                             self.voxel), self.mcfg)
        first = t["first_iteration"]
        self.state = state._replace(step=torch.full((), first - 1, dtype=torch.int32,
                                                    device=dev))
        self.it = first
        self.losses, self.first_grad_mu = [], None
        for _ in range(t["checked_steps"]):
            self.state, m = self.trainer.step(self.state, self.next_frame(), self.it)
            self.losses.append(m.loss.total.clone())
            if self.first_grad_mu is None:
                self.first_grad_mu = clone_tree(self.state.opt.mu)
            self.it += 1
        self.checked_params = clone_tree(self.state.params)
        self.checked_frames = list(self.drawn)
        # the loop itself, densify calls included, before the window: on
        # the H100 a process runs it 3-7% slower in its first ~15 s
        self.failed, self.densify_s = 0, []
        self.window(0.0, count=t["warm_iterations"])
        self.iterations = 0
        self.densify_s = []
        self.window_s = 0.0

    def next_frame(self):
        if not self.stack:
            self.stack = list(range(len(self.frames)))
        i = self.stack.pop(self.rng.randint(0, len(self.stack) - 1))
        self.drawn.append(i)
        return self.frames[i]

    def window(self, seconds: float, trace: Optional[Callable] = None,
               count: Optional[int] = None) -> None:
        """Iterate until `seconds` have passed at a loss read (or `count`
        iterations); `trace(i)` is called before iteration i of the window
        and after the last, to start and stop a traced segment."""
        tr, o = self.trainer, self.ocfg
        state, n, d0 = self.state, 0, len(self.drawn)
        t0 = time.perf_counter()
        while True:
            if trace is not None:
                if n == getattr(trace, "start", None):
                    self.traced_state = (clone_tree(state.params), state.valid.clone())
                trace(n)
            it = self.it
            with self.spans("step"):
                state, m = tr.step(state, self.next_frame(), it)
            stop = False
            if it % self.log_every == 0:
                with self.spans("loss read"):
                    loss = float(m.loss.total)
                if not math.isfinite(loss):
                    self.failed += self.log_every
                stop = (n + 1 >= count if count is not None
                        else time.perf_counter() - t0 >= seconds)
            if it % o.update_interval == 0 and tr.should_densify(int(m.n_anchors), it):
                with self.spans("densify"):
                    td = time.perf_counter()
                    state, ds = tr.densify(state, self.densify_gen, self.voxel)
                    int(ds.n_grown)                 # the CLI logs it: the host waits here
                    self.densify_s.append(time.perf_counter() - td)
            elif tr.should_maintain(it):
                state = tr.maintain(state)
            self.it += 1
            n += 1
            if stop:
                break
        sync(self.dev)
        self.window_s = time.perf_counter() - t0
        if trace is not None:
            trace(n)
            start = getattr(trace, "start", 0)
            self.traced_draws = self.drawn[d0 + start:d0 + start + getattr(trace, "count", n)]
        self.state, self.iterations = state, n
        self.anchors_end = int(state.valid.sum())

    def counted_inputs(self, n: int):
        """(params, valid, train frame ids) of the work the traced segment
        did: the field as the segment started (a copy, taken outside the
        traced span) and `n` of the frames drawn in it, evenly spaced; None
        without a traced segment."""
        state = getattr(self, "traced_state", None)
        draws = getattr(self, "traced_draws", [])
        if state is None or not draws:
            return None
        n = min(n, len(draws))
        return state[0], state[1], [draws[(2 * j + 1) * len(draws) // (2 * n)] for j in range(n)]

    def program_results(self) -> dict:
        """What the check compares, copied off the program's buffers."""
        return {"losses": torch.stack(self.losses),
                "first_grad": _scaled(self.first_grad_mu, 1.0 - ADAM_B1),
                "params": self.checked_params,
                "frames": self.checked_frames}


def _scaled(tree, denom: float):
    """Adam's first moment after one step, (1 - b1) g, back to g."""
    if isinstance(tree, dict):
        return {k: _scaled(v, denom) for k, v in tree.items()}
    return tree / denom


class RenderDrive:
    """A closed loop of the port's `Trainer.render` over novel poses,
    cycled. Each frame is timed from its call to its completion on the
    device by two CUDA events (on the CPU, by the host clock). The outputs
    of the poses in `checked` are kept at their first render."""

    def __init__(self, cell, seed: int, inputs, dev: torch.device, poses: list,
                 checked: list, stages=()):
        from lidargs_torch.train.trainer import Trainer

        self.dev = dev
        warm_frames = cell.traffic["warm_frames"]
        self.mcfg, self.rcfg, self.ocfg = port_configs(cell.config)
        self.trainer = Trainer(mcfg=self.mcfg, ocfg=self.ocfg, rcfg=self.rcfg,
                               bg=torch.zeros((self.mcfg.color_channel,), device=dev),
                               variant=cell.config["variant"], **stage_args(stages))
        H, W = cell.config["sensor"]["H"], cell.config["sensor"]["W"]
        gt = torch.zeros((3, H, W), dtype=torch.float32, device=dev)
        self.frames = [port_frame(p, gt, inputs.scene.beams, 0) for p in poses]
        self.params, self.valid = clone_tree(inputs.params), inputs.valid.clone()
        self.checked = set(checked)
        self.spans = Spans()
        for _ in range(WARM_RENDERS):
            out = self.trainer.render(self.params, self.valid, self.frames[0])
        # the checked frames are copied into buffers made here, so that the
        # window allocates nothing that outlives a frame
        self.kept = {i: (torch.empty_like(out.color), torch.empty_like(out.depth))
                     for i in self.checked}
        self.done: set = set()
        self.failed, self.latency_ms = 0, []
        # the loop itself before the window (see TrainDrive)
        self.window(0.0, count=warm_frames)
        self.iterations = 0
        self.latency_ms, self.done = [], set()
        self.window_s = 0.0

    def window(self, seconds: float, trace: Optional[Callable] = None,
               count: Optional[int] = None) -> None:
        """Render until `seconds` have passed and every checked pose has
        been rendered once (or `count` frames). At the cells' sizes the
        trajectory comes round within a second, so the time decides."""
        cuda = self.dev.type == "cuda"
        if cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        n, lat = 0, self.latency_ms
        t0 = time.perf_counter()
        while (n < count if count is not None
               else time.perf_counter() - t0 < seconds or self.done != self.checked):
            if trace is not None:
                trace(n)
            i = n % len(self.frames)
            with self.spans("render"):
                if cuda:
                    a.record()
                    out = self.trainer.render(self.params, self.valid, self.frames[i])
                    b.record()
                    b.synchronize()
                    lat.append(a.elapsed_time(b))
                else:
                    tc = time.perf_counter()
                    out = self.trainer.render(self.params, self.valid, self.frames[i])
                    lat.append((time.perf_counter() - tc) * 1e3)
            if i in self.checked and i not in self.done:
                self.kept[i][0].copy_(out.color)
                self.kept[i][1].copy_(out.depth)
                self.done.add(i)
            n += 1
        self.window_s = time.perf_counter() - t0
        if trace is not None:
            trace(n)
        self.iterations = n

    def program_results(self) -> dict:
        missing = self.checked - self.done
        if missing:
            raise RuntimeError(f"the window ended before poses {sorted(missing)} were rendered")
        return {"frames": dict(self.kept)}


def checked_poses(seed: int, n_poses: int, n: int) -> list:
    """The poses whose frames the check compares: `n` of the first
    `n_poses`, drawn from the seed."""
    rng = np.random.default_rng([seed, 2])
    return sorted(rng.choice(n_poses, size=min(n, n_poses), replace=False).tolist())
