"""What the metric readers (`metrics/<name>.py`) share: each takes the
run's record and returns a number, or None when the run has nothing for it
to read (another kind of cell, no trace, no row, no kernel of that name).

The record: `kind` ("train" or "render"), `variant`, `model` (the
configuration's model group), `setup_s`, `window_s` and `iterations`
(iterations or frames) of the window, `latency_ms` (each frame's),
`densify_s` (each densify call's host seconds), `trace` (a
`tracing.TraceSummary` of the traced segment), `rows` ({row: ms} of
`rows.py`) and `work` (the reference's `counts.Work` of the traced
segment's work: train, a few of its frames on the field it trained;
render, the checked frames, drawn over the whole trajectory it renders).
"""
from __future__ import annotations

import statistics
from typing import Optional

from . import counts

# the port's composite kernels as a trace's device rows name them (K1, K2;
# K5, K6; their window forms K3/K4, K7/K8 share the names)
COMPOSITE_KERNELS = ("composite_fwd_kernel", "composite_bwd_kernel", "surfel_fwd_kernel",
                     "surfel_bwd_kernel")


def traced(rec, kind: str):
    """The trace of a cell of `kind`, or None."""
    if rec.kind != kind or rec.trace is None or rec.trace.units <= 0:
        return None
    return rec.trace


def idle_pct(rec, kind: str) -> Optional[float]:
    tr = traced(rec, kind)
    return None if tr is None else 100.0 * (tr.window_s - tr.busy_s) / tr.window_s


def launches(rec, kind: str) -> Optional[float]:
    tr = traced(rec, kind)
    return None if tr is None else tr.n_ops / tr.units


def composite_ms(rec, kind: str) -> Optional[float]:
    """Device ms of the composite kernels a step or frame."""
    tr = traced(rec, kind)
    if tr is None:
        return None
    s = sum(v for n, v in tr.seconds_by_name.items() if any(k in n for k in COMPOSITE_KERNELS))
    return s * 1e3 / tr.units if s > 0 else None


def composite_roofline(rec, kind: str) -> Optional[float]:
    """The composite kernels' bound a step or frame (the reference's tile
    lists of the counted frames) over their measured device ms."""
    ms = composite_ms(rec, kind)
    if ms is None or not rec.work:
        return None
    train = kind == "train"
    bound = statistics.mean(w.composite_fwd.ms + (w.composite_bwd.ms if train else 0.0)
                            for w in rec.work)
    return 100.0 * bound / ms


def mfu(rec, kind: str) -> Optional[float]:
    """The FP32 operations a step or frame needs (`counts.step_ops` of the
    reference's work) over the traced time a step or frame at 67 TFLOP/s."""
    tr = traced(rec, kind)
    if tr is None or not rec.work:
        return None
    ops = statistics.mean(counts.step_ops(w, rec.model, rec.variant, kind == "train")
                          for w in rec.work)
    return 100.0 * ops / (tr.window_s / tr.units * counts.PEAK_FP32_OPS_PER_S)


def row(rec, kind: str, name: str, minus: Optional[str] = None) -> Optional[float]:
    """A prefix row's ms, or its difference from the row `minus`."""
    if rec.kind != kind or name not in rec.rows or (minus and minus not in rec.rows):
        return None
    return rec.rows[name] - (rec.rows[minus] if minus else 0.0)
