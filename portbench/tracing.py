"""The traced segment of a window and its reduction to numbers.

A trace is torch.profiler over the host and the device for a fixed number
of the window's iterations or frames, inside one named host span
(`WINDOW`), taken once in the run's fresh process (the port's own reader,
`lidargs_torch/utils/profiling.py` `profile`, found that a fresh process
keeps every record, a long one does not). Its Chrome trace is read back
and reduced: the device operations (kernels, copies, fills) clipped to the
span, their union (the seconds the device was busy), their time by name,
and the longest gaps between them, each named by the innermost host span
or operator that was running at its middle.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import NamedTuple, Optional

import torch

WINDOW = "portbench.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "python_function")
TOP = 10                       # entries of each breakdown list


class TraceSummary(NamedTuple):
    window_s: float            # the traced span's length
    busy_s: float              # the union of device operations inside it
    n_ops: int                 # device operations inside it
    seconds_by_name: dict      # device seconds by operation name
    gaps: list                 # [(host activity, seconds)], longest first
    units: int                 # iterations or frames inside the span


def union_seconds(intervals: list) -> float:
    """Seconds covered by [(start_us, end_us)] intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total * 1e-6


def idle_gaps(intervals: list, w0: float, w1: float) -> list:
    """[(middle_us, seconds)] of the stretches of [w0, w1] that no interval
    covers."""
    gaps, end = [], w0
    for a, b in sorted(intervals):
        if a > end:
            gaps.append(((a + end) / 2, (a - end) * 1e-6))
        end = max(end, b)
    if w1 > end:
        gaps.append(((w1 + end) / 2, (w1 - end) * 1e-6))
    return gaps


def reduce_events(events: list, units: int) -> Optional[TraceSummary]:
    """A TraceSummary of a Chrome trace's events, or None when the trace
    has no `WINDOW` span or no device operation inside it."""
    spans = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not spans:
        return None
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])
    dev, by_name = [], {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if b <= a:
            continue
        dev.append((a, b))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a) * 1e-6
    if not dev:
        return None
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                   for e in events if e.get("cat") in HOST_CATS and e.get("name") != WINDOW),
                  key=lambda h: h[0])
    longest = sorted(idle_gaps(dev, w0, w1), key=lambda g: -g[1])[:TOP]
    named = []
    for mid, sec in longest:
        inside = [h for h in host if h[0] <= mid < h[1]]
        named.append((max(inside, key=lambda h: h[0])[2] if inside else "host: outside any span",
                      sec))
    return TraceSummary((w1 - w0) * 1e-6, union_seconds(dev), len(dev), by_name, named, units)


class Tracer:
    """The profiler starts when the tracer is made (before the window, so
    that its start-up falls outside it); `tracer(n)`, called before the
    n-th iteration or frame of a window and after its last, opens the
    `WINDOW` span at n == `start` and stops the profiler at n == `start +
    count` (or at the end of the window). `spans` (a drive's `Spans`) is
    switched on while the span is open."""

    def __init__(self, start: int, count: int, spans, dev: torch.device):
        from torch.profiler import ProfilerActivity, profile

        self.start, self.count, self.spans, self.dev = start, count, spans, dev
        self.mark = None
        self.began = 0
        self.summary: Optional[TraceSummary] = None
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()

    def __call__(self, n: int) -> None:
        if self.prof is None:
            return
        if self.mark is None and n == self.start:
            self._sync()
            self.mark = torch.profiler.record_function(WINDOW)
            self.mark.__enter__()
            self.spans.on = True
            self.began = n
        elif self.mark is not None and n >= self.start + self.count:
            self.stop(n)

    def stop(self, n: int) -> None:
        if self.prof is None:
            return
        if self.mark is None:
            self.prof.__exit__(None, None, None)
            self.prof = None
            return
        self._sync()
        self.mark.__exit__(None, None, None)
        self.spans.on = False
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.prof = None
        self.summary = reduce_events(events, n - self.began)

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
