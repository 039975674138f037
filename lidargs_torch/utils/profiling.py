"""Step timing, device traces and scalar loggers of the training CLI.

Counterpart of `lidargs_tpu/utils/profiling.py`:

  * StepTimer: wall-clock ms between ticks, ending in a device synchronize
    when given a result;
  * trace(...): a context manager around torch.profiler that writes a
    Chrome trace of the enclosed block into a directory;
  * annotate(...): a named span (torch.profiler.record_function), so a
    pipeline stage shows by name in that trace;
  * telemetry (`Telemetry`), the port's own recorder: stage stamps on the
    device's clock inside the step's and the render's CUDA graphs
    (`csrc/stamp.cu`), the step's counters in a device ring read without a
    synchronize, and host spans on one timeline with them;
  * profile(...): device ms and device launches a call from torch.profiler;
    event_ms(...): the CUDA-event ms of each call of a function, after
    warm-up calls, back to back or each alone on a cold L2 cache; and
    time_in_turns(...): CUDA-event ms of several functions timed in
    alternating order (the port's timing tools all time through these);
  * TensorBoardLogger and WandbLogger, which stay inactive when their
    package is absent.
"""
from __future__ import annotations

import bisect
import contextlib
import ctypes
import json
import os
import time
from typing import Optional

import numpy as np
import torch


class StepTimer:
    """Wall-clock ms between ticks. Pass the step's output to tick() to wait
    for the device first."""

    def __init__(self):
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def tick(self, result=None) -> float:
        """The ms since the last tick (or start); with `result` (a tensor),
        synchronize its device first."""
        if isinstance(result, torch.Tensor) and result.is_cuda:
            torch.cuda.synchronize(result.device)
        t1 = time.perf_counter()
        dt_ms = (t1 - self._t0) * 1e3 if self._t0 is not None else 0.0
        self._t0 = t1
        return dt_ms


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


# the port's composite kernels (K1-K8), as a trace's device rows name them
PORT_KERNELS = ("composite_fwd_kernel", "composite_bwd_kernel", "surfel_fwd_kernel",
                "surfel_bwd_kernel")


def profile(run, calls: int = 3) -> dict:
    """torch.profiler over `calls` calls of `run` (after one profiled call
    that warms the tracer up): device ms and device-side launches a call
    (kernels, copies and memsets), in total, for the costliest kernels
    (`top`) and for each of PORT_KERNELS; the host-side runtime calls a
    call. Each call launches the same kernels, so a count that is not a
    multiple of `calls` shows that the trace lost records: `complete` says
    whether it kept them all, `uneven` lists the counts that say it did not.
    Without device time in the trace the device figures are "not measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    def dev_us(e):
        v = getattr(e, "device_time_total", None)
        return v if v is not None else getattr(e, "cuda_time_total", 0.0)

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    # a Trainer call under the profiler switches the recorder on: the
    # warm-up call takes that, and the recorder is left as it was found
    was_on = telemetry.on
    with torch_profile(activities=activities):
        run()
        torch.cuda.synchronize()
    with torch_profile(activities=activities) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    if not was_on:
        telemetry.disable()
    events = prof.key_averages()
    # the device's own rows; the operator rows that launched them would
    # count the same time again
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    # host-side runtime calls (a host scalar written to the card is a
    # pageable copy and a synchronize, which a CUDA graph could not hold)
    # and the copies by kind
    runtime = {e.key: e.count / calls for e in events
               if e.key in ("cudaStreamSynchronize", "cudaMemcpyAsync")
               or e.key.startswith("Memcpy")}
    if not kernels:
        return {"frames": calls, "device_ms_per_frame": "not measured",
                "device_launches_per_frame": "not measured",
                "runtime_calls_per_frame": runtime, "complete": False, "port_kernels": {}}
    out = {
        "frames": calls,
        "device_ms_per_frame": sum(dev_us(e) for e in kernels) / 1e3 / calls,
        "device_launches_per_frame": sum(e.count for e in kernels) / calls,
        "runtime_calls_per_frame": runtime,
        "top": [{"name": e.key[:90], "ms_per_frame": dev_us(e) / 1e3 / calls,
                 "calls_per_frame": e.count / calls}
                for e in sorted(kernels, key=dev_us, reverse=True)[:12]],
        "port_kernels": {n: sum(e.count for e in kernels if n in e.key) / calls
                         for n in PORT_KERNELS},
        "complete": all(e.count % calls == 0 for e in kernels),
    }
    if not out["complete"]:
        out["uneven"] = {e.key[:80]: e.count for e in kernels if e.count % calls}
    return out


def _span(fn, start=None) -> tuple:
    """(start, end): CUDA events around one call of `fn` on the current
    stream; `start` is one already recorded, else a new one is."""
    if start is None:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    fn()
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    return start, end


def event_ms(fn, iters: int, warmup: int = 0, flush: bool = False) -> list:
    """[ms]: the device time of each of `iters` calls of `fn` from CUDA
    events, after `warmup` calls. The calls run back to back, each timed
    from the event that ended the one before; with `flush`, each call runs
    alone, waited for, after the card's 50 MB L2 cache is flushed (256 MB
    written outside its span)."""
    for _ in range(warmup):
        fn()
    scratch = torch.empty(2 ** 26, dtype=torch.float32, device="cuda") if flush else None
    torch.cuda.synchronize()
    spans = []
    for _ in range(iters):
        if flush:
            scratch.zero_()
        spans.append(_span(fn, None if flush or not spans else spans[-1][1]))
        if flush:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in spans]


def time_in_turns(runs: dict, n: int, warmup: int = 3) -> dict:
    """{key: [ms]}: CUDA-event ms of each of `runs`, timed in `n` rounds
    that call every run once, each between two events, in order on even
    rounds and reversed on odd ones, so that drift falls on all alike;
    `warmup` calls of each first."""
    for run in runs.values():
        for _ in range(warmup):
            run()
    torch.cuda.synchronize()
    keys = list(runs)
    events = {k: [] for k in keys}
    for r in range(n):
        for k in (keys if r % 2 == 0 else keys[::-1]):
            events[k].append(_span(runs[k]))
    torch.cuda.synchronize()
    return {k: [a.elapsed_time(b) for a, b in v] for k, v in events.items()}


def annotate(name: str):
    """Named span in the profiler trace (torch.profiler.record_function),
    as a context manager."""
    return torch.profiler.record_function(name)


# --- the in-program recorder ---------------------------------------------

RING_ENTRIES = 1 << 18         # entries of a device ring (ring buffer: the oldest are overwritten)
# every id an entry can carry: the stage stamps, the begin stamp's profiler
# tag, then the counters (each counter group consecutive: a stamp writes its
# values under first_id, first_id + 1, ...)
IDS = ("begin", "front", "raster", "composite", "loss", "loss_bwd", "composite_bwd",
       "raster_bwd", "grad", "end", "refine", "densify_begin", "densify_end", "clock",
       "profiled", "n_visible", "n_overflow", "n_dropped", "n_anchors", "n_grown",
       "n_pruned", "n_flipped", "rows")
ID = {name: i for i, name in enumerate(IDS)}
STAMPS = tuple(range(ID["clock"] + 1))
# a step's or frame's stamps in the order the stream runs them, each paired
# with the stage whose time it closes (the backward's in reverse order)
SEQUENCES = {
    "train": (("front", "front"), ("raster", "raster"), ("composite", "composite"),
              ("loss", "loss"), ("loss_bwd", "loss"), ("composite_bwd", "composite"),
              ("raster_bwd", "raster"), ("grad", "front"), ("end", "adam")),
    "render": (("front", "front"), ("raster", "raster"), ("end", "composite")),
}
# a frame whose ray drop the refiner replaces (`train/graphs.py` `refine_frame`),
# summarized as a render with one stage more
REFINED = (("front", "front"), ("raster", "raster"), ("refine", "composite"),
           ("end", "refine"))
_SEQUENCE_OF = {tuple([ID["begin"]] + [ID[s] for s, _ in seq]): (kind, seq)
                for kind, seq in list(SEQUENCES.items()) + [("render", REFINED)]}
CALIBRATE_EVERY_NS = 1_000_000_000   # a summary re-reads the clock offset after this long
_NULL = contextlib.nullcontext()


def _profiling() -> bool:
    return torch.autograd.profiler._is_profiler_enabled


class _Ring:
    """One device's stamps: the control words and the ring on a card (the
    stamp kernel, `csrc/stamp.cu`), the same layout in host memory on the
    CPU; the entries read back, parsed into steps; the clock offsets."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.ctl = torch.zeros(4, dtype=torch.int64, device=device)
            self.buf = torch.zeros((RING_ENTRIES, 3), dtype=torch.int64, device=device)
        else:
            self.ctl = [0, 0, 0, 0]
            self.host: list = []
        self.reset()

    def reset(self) -> None:
        self.read = 0              # entries copied to the host
        self.lost = 0              # entries overwritten before they were read
        self.steps: dict = {}      # step id -> _Step
        self.clock: list = []      # (device ns, offset ns, error ns), offset = device - host

    # -- writing --
    def start(self, profiled: bool) -> None:
        """Switch on from an empty ring (step ids from 1)."""
        self.reset()
        if self.cuda:
            self.ctl.copy_(torch.tensor([1, 0, 0, int(profiled)], dtype=torch.int64))
            self.calibrate()
        else:
            self.ctl[:] = [1, 0, 0, int(profiled)]
            self.host = []

    def stop(self) -> None:
        if self.cuda:
            self.ctl[0:1].fill_(0)
        else:
            self.ctl[0] = 0

    def tag(self, profiled: bool) -> None:
        """Whether a profiler runs, copied into each later begin stamp."""
        if self.cuda:
            self.ctl[3:4].fill_(int(profiled))
        else:
            self.ctl[3] = int(profiled)

    def emit(self, stamp: int, values=(), first: int = 0, rows: int = -1) -> None:
        """Append a stamp (and its values, `rows`): a launch of the stamp
        kernel on the current stream, or a host append on the CPU."""
        begin = stamp == ID["begin"]
        if not self.cuda:
            ctl = self.ctl
            if not ctl[0]:
                return
            t = time.perf_counter_ns()
            if begin:
                ctl[2] += 1
            e = self.host
            n0 = len(e)
            e.append((ctl[2], stamp, t))
            if begin:
                e.append((ctl[2], ID["profiled"], ctl[3]))
            # the values are read back at the next drain, as a card's are
            e.extend((ctl[2], first + i, v.detach().clone()) for i, v in enumerate(values)
                     if v is not None)
            if rows >= 0:
                e.append((ctl[2], ID["rows"], rows))
            ctl[1] += len(e) - n0
            return
        from . import cuda_build

        ptrs = []
        for v in (tuple(values) + (None,) * 3)[:3]:
            if v is not None and (v.dtype != torch.int64 or v.numel() != 1
                                  or v.device != self.device):
                raise ValueError(f"a stamp's value must be an int64 scalar on {self.device}: "
                                 f"{v.dtype} {tuple(v.shape)} on {v.device}")
            ptrs.append(None if v is None else v.data_ptr())
        fn, err_str = cuda_build.entry("stamp", "lidargs_stamp", _STAMP_ARGS)
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            err = fn(self.ctl.data_ptr(), self.buf.data_ptr(), *ptrs, RING_ENTRIES, stamp,
                     int(begin), ID["profiled"], first, rows, ID["rows"], stream)
        if err != 0:
            raise RuntimeError(f"lidargs_stamp launch failed: {err_str(err).decode()}")

    def calibrate(self, rounds: int = 3) -> None:
        """The offset of %globaltimer from the host's perf_counter_ns:
        synchronize, read the host clock, stamp, synchronize, read it again;
        of `rounds` tries the one with the narrowest bracket, its half width
        as the error."""
        brackets = []
        for _ in range(rounds):
            torch.cuda.synchronize(self.device)
            h0 = time.perf_counter_ns()
            self.emit(ID["clock"])
            torch.cuda.synchronize(self.device)
            brackets.append((h0, time.perf_counter_ns()))
        stamps = [e for e in self.drain() if e[1] == ID["clock"]][-rounds:]
        best = min(zip(stamps, brackets), key=lambda p: p[1][1] - p[1][0])
        (_, _, dev_ns), (h0, h1) = best
        self.clock.append((dev_ns, dev_ns - (h0 + h1) // 2, (h1 - h0) // 2))

    # -- reading --
    def drain(self) -> list:
        """Copy the entries written since the last read to the host (a
        synchronize on a card) and parse them; returns them."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
            n = int(self.ctl[1])
            lo = max(self.read, n - RING_ENTRIES)
            self.lost += lo - self.read
            if n > lo:
                a, b = lo % RING_ENTRIES, (n - 1) % RING_ENTRIES + 1
                parts = [self.buf[a:b]] if a < b else [self.buf[a:], self.buf[:b]]
                new = [tuple(r) for p in parts for r in p.cpu().tolist()]
            else:
                new = []
            self.read = n
        else:
            new = [(st, i, v if isinstance(v, int) else int(v)) for st, i, v in self.host]
            self.host = []
            self.read += len(new)
        for step, ident, value in new:
            if ident == ID["clock"]:
                continue
            rec = self.steps.get(step)
            if rec is None:
                rec = self.steps[step] = _Step()
            if ident in STAMPS:
                (rec.densify if ident in (ID["densify_begin"], ID["densify_end"])
                 else rec.stamps).append((ident, value))
            else:
                rec.counts[IDS[ident]] = value
        return new

    def to_host(self, dev_ns):
        """Device ns on the host's perf_counter_ns clock (the offsets
        interpolated between calibrations); unchanged on the CPU."""
        if not self.clock:
            return np.asarray(dev_ns, dtype=np.float64)
        d = np.array([c[0] for c in self.clock], dtype=np.float64)
        off = np.array([c[1] for c in self.clock], dtype=np.float64)
        x = np.asarray(dev_ns, dtype=np.float64)
        return x - np.interp(x, d, off)


class _Step:
    """A step's or frame's entries: its stage stamps in order, its densify
    stamps and its counters."""
    __slots__ = ("stamps", "densify", "counts")

    def __init__(self):
        self.stamps: list = []
        self.densify: list = []
        self.counts: dict = {}

    @property
    def kind(self) -> Optional[str]:
        """"train" or "render" when its stamps are complete and in order."""
        return self.sequence[0]

    @property
    def sequence(self) -> tuple:
        """(kind, its SEQUENCES entry or REFINED), or (None, ()) while its
        stamps are incomplete or out of order."""
        return _SEQUENCE_OF.get(tuple(s for s, _ in self.stamps), (None, ()))

    @property
    def profiled(self) -> bool:
        return bool(self.counts.get("profiled", 0))

    def densify_ns(self) -> Optional[int]:
        t = dict(self.densify)
        if ID["densify_begin"] in t and ID["densify_end"] in t:
            return t[ID["densify_end"]] - t[ID["densify_begin"]]
        return None


_STAMP_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
               + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


class _Scope:
    __slots__ = ("tel",)

    def __init__(self, tel):
        self.tel = tel

    def __enter__(self):
        self.tel.inside += 1

    def __exit__(self, *exc):
        self.tel.inside -= 1


class _Span:
    __slots__ = ("tel", "name", "rec", "mark")

    def __init__(self, tel, name: str):
        self.tel, self.name, self.mark = tel, name, None

    def __enter__(self):
        tel = self.tel
        if not tel._open and self.name in ("step", "render"):
            tel._host_step += 1
        self.rec = [self.name, time.perf_counter_ns(), None,
                    tel._open[-1] if tel._open else -1, tel._host_step]
        tel._open.append(len(tel.spans))
        tel.spans.append(self.rec)
        if _profiling():
            self.mark = annotate(self.name)
            self.mark.__enter__()
        return self

    def __exit__(self, *exc):
        if self.mark is not None:
            self.mark.__exit__(*exc)
        self.rec[2] = time.perf_counter_ns()
        self.tel._open.pop()


class _Boundary(torch.autograd.Function):
    """The identity, whose backward stamps `stage` when the gradient
    crosses back over the boundary."""

    @staticmethod
    def forward(ctx, tel, stage, *xs):
        ctx.tel, ctx.stage = tel, stage
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        ctx.tel.stamp(ctx.stage, next(g for g in gs if g is not None))
        return (None, None) + gs


class Telemetry:
    """Stage stamps on the device's own clock, counters and host spans.

    Stamps (`stamp`, `boundary`) are placed at the layer boundaries of the
    training step and the render; they record only inside a program scope
    (`scope`), which `Trainer.step` and `Trainer.render` hold while their
    programs are captured and run, so other programs made of the same
    functions (the stage split's rows, the data-parallel programs) hold
    none. On a card a stamp is one launch of `csrc/stamp.cu`, captured into
    the program's CUDA graph whether the recorder is on or off; off, it
    returns at once, so switching never recaptures. Capture warm-ups
    (`warming`) stamp nothing. On the CPU a stamp appends the host's
    `perf_counter_ns` to the same layout in host memory, only while on.

    A train step's stamps: begin | front | raster | composite | loss, the
    backward's loss_bwd | composite_bwd | raster_bwd | grad (through the
    identity `_Boundary`, whose backward stamps), then end after Adam, the
    statistics and the commit. A frame's: begin | front | raster | end; a
    refined frame's (a ray-drop refiner in the render's program) begin |
    front | raster | refine | end, summarized as a render whose composite
    stage ends at refine and whose refine stage runs to end. The front
    stamp carries `n_visible` and the rows the front processed; end carries
    `n_overflow`, `n_dropped` (and a step's `n_anchors`), a refined frame's
    refine carries those two and its end `n_flipped`;
    `Trainer.densify`'s eager densify_begin / densify_end carry `n_grown`
    and `n_pruned`. Each begin stamp advances the step id and tags the step
    with whether a profiler was running.

    Host spans (`span`): name, start, end, parent and host step id, kept in
    memory while on, and emitted through `annotate` while a profiler runs;
    off, a span is one attribute check. `captures` counts the static
    programs made (`train/graphs.py`: a CUDA graph captured on a card, each
    under a span `capture`), `extent` the anchor rows of the last step or
    render program built (its live extent), `fused_fronts` the render
    programs made, and eager frames rendered, whose front ran as one kernel
    (`ops/front_kernel.py`: `front_packed`'s F1 or `surfel_front_packed`'s
    F2, on a card). `enable()` switches on (and
    measures each card's clock offset), `disable()` off; a `Trainer` call
    that finds a profiler running switches it on (`notice`). Nothing is read
    from a card until `summary`, which synchronizes once and leaves out the
    profiled steps."""

    def __init__(self):
        self.on = False
        self.inside = 0            # depth of program scopes
        self.warming = False       # a capture's eager warm-up runs
        self.profiled = False      # whether a profiler ran at the last notice
        self.rings: dict = {}      # device -> _Ring
        self.spans: list = []      # [name, start ns, end ns, parent index, host step id]
        self._open: list = []
        self._host_step = 0
        self._scope = _Scope(self)
        self.captures = 0          # static programs made (since switched on)
        self.extent: Optional[int] = None   # anchor rows of the last program built
        self.fused_fronts = 0      # render programs and eager frames with the one-kernel front

    # -- switching --
    def enable(self) -> None:
        """Switch on, from empty records."""
        if self.on:
            return
        self.on = True
        self.profiled = _profiling()
        self.spans, self._open, self._host_step = [], [], 0
        self.captures = self.fused_fronts = 0
        for ring in self.rings.values():
            ring.start(self.profiled)

    def disable(self) -> None:
        """Switch off; the records stay readable."""
        if not self.on:
            return
        for ring in self.rings.values():
            ring.drain()
            ring.stop()
        self.on = False

    def notice(self) -> None:
        """At a Trainer call: a profiler that started switches the recorder
        on, and the steps from here on are tagged with whether one runs."""
        prof = _profiling()
        if prof == self.profiled:
            return
        if prof and not self.on:
            self.enable()
            return
        self.profiled = prof
        if self.on:
            for ring in self.rings.values():
                ring.tag(prof)

    def ring(self, device: torch.device) -> _Ring:
        ring = self.rings.get(device)
        if ring is None:
            if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("the stamp ring must be made before a capture")
            ring = self.rings[device] = _Ring(device)
            if device.type == "cuda":
                ring.emit(ID["clock"])     # loads the kernel before any capture; off, a no-op
            if self.on:
                ring.start(self.profiled)
        return ring

    # -- recording --
    def scope(self, device: torch.device) -> _Scope:
        """The scope inside which stamps record (made before a capture on a
        card, where it makes the device's ring)."""
        if device.type == "cuda" and device not in self.rings:
            self.ring(device)
        return self._scope

    def stamp(self, name: str, like: torch.Tensor, values=(), first: str = "n_visible",
              rows: int = -1) -> None:
        """A program's stamp `name` on `like`'s device, with device scalars
        `values` under the ids from `first` on, and `rows`; nothing outside
        a program scope or in a warm-up."""
        if self._live(like.device):
            self.ring(like.device).emit(ID[name], values, ID[first], rows)

    def _live(self, dev: torch.device) -> bool:
        """Whether a program's stamp records: inside a program scope and not
        in a warm-up, while on or (on a card) while a capture records it."""
        return self.inside and not self.warming and (
            self.on or (dev.type == "cuda" and torch.cuda.is_current_stream_capturing()))

    def mark(self, name: str, like: torch.Tensor, values=(), first: str = "n_grown") -> None:
        """An eager stamp outside the programs (densify's), while on."""
        if self.on:
            self.ring(like.device).emit(ID[name], values, ID[first])

    def boundary(self, fwd: str, bwd: Optional[str], *xs, values=(),
                 first: str = "n_visible", rows: int = -1) -> tuple:
        """Stamp `fwd` as the forward crosses a boundary with tensors `xs`,
        and `bwd` when their gradient crosses back (through `_Boundary`);
        `xs` unchanged where a stamp would not record."""
        if not self._live(xs[0].device):
            return xs
        self.ring(xs[0].device).emit(ID[fwd], values, ID[first], rows)
        if bwd is None or not torch.is_grad_enabled() or not any(x.requires_grad for x in xs):
            return xs
        return _Boundary.apply(self, bwd, *xs)

    def span(self, name: str):
        """A host span while on; a no-op context otherwise."""
        return _Span(self, name) if self.on else _NULL

    # -- reading --
    def summary(self, kind: str, last: Optional[int] = None) -> Optional[dict]:
        """What the rings hold of `kind`'s ("train" or "render") unprofiled,
        complete steps (the `last` ones only, if given), in ms: each
        stage's mean device time, forward plus backward (`stage_ms`, with
        `refine` where refined frames are among them); the
        mean graph span (begin to end), period (begin to the next begin) and
        host gap (end to the next step's begin, densify calls left out);
        densify's mean device time; the counters' means; the front's fill
        (100 n_visible / rows); the host gaps' ms a step by the host span
        open at their middle (`gaps`, and the `longest` few); the clock
        offsets; the programs captured since switched on, their mean host ms,
        the current extent and the renders whose front ran as one kernel
        (`captures`, `capture_ms`, `extent`, `fused_fronts`). None
        when there is no such step."""
        steps = []
        for ring in self.rings.values():
            if ring.cuda and self.on and (
                    not ring.clock or time.perf_counter_ns() - ring.clock[-1][0]
                    + ring.clock[-1][1] > CALIBRATE_EVERY_NS):
                ring.calibrate()
            else:
                ring.drain()
            if last:             # from the newest back, so a log line reads only the tail
                tail = []
                for s, r in reversed(ring.steps.items()):
                    if r.kind == kind and not r.profiled:
                        tail.append((ring, s, r))
                        if len(tail) == last:
                            break
                steps.extend(reversed(tail))
            else:
                steps.extend((ring, s, r) for s, r in sorted(ring.steps.items())
                             if r.kind == kind and not r.profiled)
        if last:
            steps = steps[-last:]
        if not steps:
            return None
        stage_ns: dict = {}
        spans_ns, periods, gaps, gap_mid, densify = [], [], [], [], []
        counts: dict = {}
        for ring, s, r in steps:
            t = [v for _, v in r.stamps]
            for (_, stage), a, b in zip(r.sequence[1], t, t[1:]):
                stage_ns[stage] = stage_ns.get(stage, 0) + b - a
            spans_ns.append(t[-1] - t[0])
            for k, v in r.counts.items():
                counts.setdefault(k, []).append(v)
            d = r.densify_ns()
            if d is not None:
                densify.append(d)
            nxt = ring.steps.get(s + 1)
            if nxt is not None and nxt.kind == kind and not nxt.profiled:
                periods.append(nxt.stamps[0][1] - t[0])
                if d is None and not r.densify:
                    gaps.append(nxt.stamps[0][1] - t[-1])
                    gap_mid.append((ring, (nxt.stamps[0][1] + t[-1]) / 2, gaps[-1]))
        n = len(steps)
        mean = lambda xs: sum(xs) / len(xs) / 1e6 if xs else None
        out = {
            "kind": kind, "steps": n,
            "profiled_steps": None if last else sum(
                r.kind == kind and r.profiled for ring in self.rings.values()
                for r in ring.steps.values()),
            "stage_ms": {k: v / n / 1e6 for k, v in stage_ns.items()},
            "graph_ms": mean(spans_ns), "period_ms": mean(periods),
            "host_gap_ms": mean(gaps), "densify_ms": mean(densify),
            "densify_calls": len(densify),
            "counters": {k: sum(v) / len(v) for k, v in counts.items() if k != "profiled"},
            "lost_entries": sum(ring.lost for ring in self.rings.values()),
            "captures": self.captures, "extent": self.extent,
            "fused_fronts": self.fused_fronts,
            "capture_ms": mean([b - a for name, a, b, _, _ in self.spans
                                if name == "capture" and b is not None]),
        }
        if "n_visible" in counts and "rows" in counts and sum(counts["rows"]) > 0:
            out["front_fill_pct"] = 100.0 * sum(counts["n_visible"]) / sum(counts["rows"])
        named = self._name_gaps(gap_mid)
        out["gaps"] = {k: v / n / 1e6 for k, v in
                       sorted(named["total"].items(), key=lambda kv: -kv[1])}
        out["longest"] = [(k, v / 1e6) for k, v in named["longest"]]
        out["clock"] = [{"device_ns": c[0], "offset_ns": c[1], "error_ns": c[2]}
                        for ring in self.rings.values() for c in ring.clock]
        return out

    def metric(self, name: str, kind: str) -> Optional[float]:
        """A per-layer metric of `kind`'s summary by its base name:
        stage_<stage>_ms, stage_densify_ms, host_gap_ms, front_fill_pct,
        tile_overflow; None when the records have nothing for it."""
        s = self.summary(kind)
        if s is None:
            return None
        if name == "stage_densify_ms":
            return s["densify_ms"]
        if name.startswith("stage_") and name.endswith("_ms"):
            return s["stage_ms"].get(name[len("stage_"):-len("_ms")])
        if name == "tile_overflow":
            return s["counters"].get("n_overflow")
        return s.get(name)

    def _name_gaps(self, gaps: list) -> dict:
        """{"total": {host span: device ns}, "longest": [(span, ns)]} of the
        device's gaps [(ring, device middle ns, length ns)], each named by
        the innermost host span open at its middle."""
        total, named = {}, []
        hosts = {}
        for ring in {id(g[0]): g[0] for g in gaps}.values():
            mine = [g for g in gaps if g[0] is ring]
            hosts.update(zip((id(g) for g in mine), ring.to_host([g[1] for g in mine])))
        for g in gaps:
            ring, mid, length = g
            h = float(hosts[id(g)])
            # spans are appended as they open, so in order of their start
            i = bisect.bisect_right(self.spans, h, key=lambda sp: sp[1]) - 1
            name = "host: outside any span"
            for j in range(i, max(i - 64, -1), -1):
                sp = self.spans[j]
                if sp[2] is not None and sp[2] > h:
                    name = sp[0]
                    break
            total[name] = total.get(name, 0) + length
            named.append((name, length))
        return {"total": total, "longest": sorted(named, key=lambda x: -x[1])[:5]}

    def write_trace(self, path: str) -> None:
        """The timeline as a Chrome trace: the host spans, and each
        recorded step's device stages on the host's clock."""
        for ring in self.rings.values():
            ring.drain()
        ev = [{"name": "process_name", "ph": "M", "pid": p, "args": {"name": n}}
              for p, n in enumerate(["host"] + [f"device {d}" for d in self.rings])]
        ev += [{"name": n, "ph": "X", "pid": 0, "tid": 0, "ts": a / 1e3,
               "dur": ((b if b is not None else a) - a) / 1e3, "args": {"step": step}}
              for n, a, b, _, step in self.spans]
        for pid, ring in enumerate(self.rings.values(), 1):
            for s, r in sorted(ring.steps.items()):
                kind = r.kind
                if kind is None:
                    continue
                t = ring.to_host([v for _, v in r.stamps]) / 1e3
                for (stamp, stage), a, b in zip(r.sequence[1], t, t[1:]):
                    name = stage + (" backward" if stamp.endswith("_bwd") or stamp == "grad"
                                    else "")
                    ev.append({"name": name, "ph": "X", "pid": pid,
                               "tid": kind, "ts": float(a), "dur": float(b - a),
                               "args": {"step": s, "profiled": r.profiled, **r.counts}})
                if r.densify_ns() is not None:
                    a, b = ring.to_host([v for _, v in r.densify]) / 1e3
                    ev.append({"name": "densify", "ph": "X", "pid": pid,
                               "tid": kind, "ts": float(a), "dur": float(b - a),
                               "args": {"step": s}})
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": ev, "displayTimeUnit": "ms"}, f)


telemetry = Telemetry()


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
