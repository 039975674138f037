"""Step timing, device traces and scalar loggers of the training CLI.

Counterpart of `lidargs_tpu/utils/profiling.py`:

  * StepTimer: wall-clock per-step stats, ending in a device synchronize
    when given a result (EMA and percentiles);
  * trace(...): a context manager around torch.profiler that writes a
    Chrome trace of the enclosed block into a directory;
  * annotate(...): a named span (torch.profiler.record_function), so a
    pipeline stage shows by name in that trace;
  * TensorBoardLogger and WandbLogger, which stay inactive when their
    package is absent.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch


class StepTimer:
    """Per-step wall-clock stats. Pass the step's output to tick() to wait
    for the device first."""

    def __init__(self, ema_decay: float = 0.98, keep: int = 10_000):
        self.ema_decay = ema_decay
        self.ema_ms: Optional[float] = None
        self.times_ms: list[float] = []
        self.keep = keep
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def tick(self, result=None) -> float:
        """Record one step; with `result` (a tensor), synchronize its
        device first."""
        if isinstance(result, torch.Tensor) and result.is_cuda:
            torch.cuda.synchronize(result.device)
        t1 = time.perf_counter()
        dt_ms = (t1 - self._t0) * 1e3 if self._t0 is not None else 0.0
        self._t0 = t1
        self.times_ms.append(dt_ms)
        if len(self.times_ms) > self.keep:
            del self.times_ms[: -self.keep]
        self.ema_ms = (dt_ms if self.ema_ms is None
                       else self.ema_decay * self.ema_ms + (1 - self.ema_decay) * dt_ms)
        return dt_ms

    def stats(self, skip: int = 2) -> dict:
        t = np.asarray(self.times_ms[skip:] or self.times_ms)
        if t.size == 0:
            return {}
        return {
            "mean_ms": float(t.mean()),
            "p50_ms": float(np.percentile(t, 50)),
            "p90_ms": float(np.percentile(t, 90)),
            "p99_ms": float(np.percentile(t, 99)),
            "steps_per_s": float(1e3 / max(t.mean(), 1e-9)),
        }


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the enclosed block (the host, and the card when
    there is one); the Chrome trace goes to `<logdir>/trace.json`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named span in the profiler trace (torch.profiler.record_function),
    as a context manager."""
    return torch.profiler.record_function(name)


class TensorBoardLogger:
    """Scalars and images through torch.utils.tensorboard; inactive when
    tensorboard is missing or `logdir` is None."""

    def __init__(self, logdir: Optional[str]):
        self._w = None
        if logdir is None:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._w = SummaryWriter(logdir)

    @property
    def active(self) -> bool:
        return self._w is not None

    def scalar(self, tag: str, value, step: int):
        if self._w is not None:
            self._w.add_scalar(tag, float(value), step)

    def scalars(self, values: dict, step: int, prefix: str = ""):
        for k, v in values.items():
            self.scalar(prefix + k, v, step)

    def image(self, tag: str, rgb01: np.ndarray, step: int):
        """[H, W, 3] float image in [0, 1]."""
        if self._w is not None:
            self._w.add_image(tag, np.transpose(np.clip(rgb01, 0, 1), (2, 0, 1)), step)

    def depth_image(self, tag: str, depth: np.ndarray, step: int, vmax: float = 80.0):
        from .visualize import depth_to_rgb

        self.image(tag, depth_to_rgb(np.asarray(depth), vmax), step)

    def close(self):
        if self._w is not None:
            self._w.close()


class WandbLogger:
    """Optional Weights & Biases sink: inactive when the package is missing
    or its init fails, since training must never depend on the logger."""

    def __init__(self, project: Optional[str], run_name: str = None, config: dict = None):
        self._wb = None
        if not project:
            return
        try:
            import wandb

            wandb.init(project=project, name=run_name, config=config or {})
        except Exception:       # any failure of the optional sink leaves it off
            return
        self._wb = wandb

    @property
    def active(self) -> bool:
        return self._wb is not None

    def log(self, values: dict, step: int = None, prefix: str = ""):
        if self._wb is None:
            return
        payload = {prefix + k: float(v) for k, v in values.items()
                   if isinstance(v, (int, float, np.floating, np.integer))}
        self._wb.log(payload, step=step)

    def finish(self):
        if self._wb is not None:
            self._wb.finish()
