"""Cumulative prefixes of the port's step and frame, each one CUDA graph,
timed in turns: where a layer's device time inside the whole is read.

A frozen copy of the rows of `lidargs_torch/utils/prefixes.py` and
`stage_split.py` that the per-layer metrics read. Each row runs the port's
production functions up to one stage and ends in a scalar that depends on
every output of that stage (`project`: prefilter, decode and projection;
`gather`: on to the cull sort, the bin sort and the tile gather), or is
the backward of one (`grad ...`: the parameters' and the densification
proxy's gradients), or a cumulative part of the training step (`render`,
`+ loss`, `+ grad`, `+ adam`: `train_step` without the statistics). Each
row is captured once as the port's `StaticProgram` in one graph pool and
replayed `ROUNDS` times in turns after `WARMUP` replays, every round
replaying each row once between two CUDA events, in order on even rounds
and reversed on odd ones. The difference of two rows' medians is a
stage's device time inside the whole.

The port's names are looked up when the rows are built: a row whose
function the port no longer has is left out, and so are the metrics that
read it.
"""
from __future__ import annotations

import statistics

import torch

ROUNDS = 20
WARMUP = 3


def _total(*xs) -> torch.Tensor:
    return sum(x.to(torch.float32).sum() for x in xs)


def _with_grads(scalar, k: int):
    from lidargs_torch.train.optim import tree_leaves, tree_unflatten

    def fn(p, v, f):
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(p)]
        proxy = torch.zeros((v.shape[0], k, 3), dtype=torch.float32, device=v.device,
                            requires_grad=True)
        with torch.enable_grad():
            total = scalar(tree_unflatten(p, leaves), v, f, proxy)
            gs = torch.autograd.grad(total, leaves + [proxy], allow_unused=True)
        return [torch.zeros_like(x) if g is None else g for g, x in zip(gs, leaves + [proxy])]
    return fn


def row_functions(state, frame, mcfg, rcfg, ocfg, bg, variant: str, train: bool) -> dict:
    """{row: compute()} of a cell: the beam prefixes (forward for a render
    cell, their backward for a train cell) and, for a train cell, the
    step's cumulative parts."""
    from lidargs_torch.models.field import field_splats, render_fn
    from lidargs_torch.ops.projection import pack_splats
    from lidargs_torch.ops.rasterize import bin_rows, cull_sorted_rows, gather_instances
    from lidargs_torch.train.trainer import frame_loss, loss_and_grads, train_step

    params, valid = state.params, state.valid
    C = mcfg.color_channel
    gy, gx = rcfg.grid_shape(frame.beams.shape[0], frame.W)

    def project(p, v, f, proxy=None):
        return _total(pack_splats(field_splats(p, v, f, mcfg, rcfg, proxy)[0]))

    def gather(p, v, f, proxy=None):
        pkv = cull_sorted_rows(field_splats(p, v, f, mcfg, rcfg, proxy)[0], rcfg)[0]
        return _total(gather_instances(pkv, bin_rows(pkv, rcfg, C, gx, gy)[0]))

    rows = {}
    if variant == "beam":
        for name, fn in (("project", project), ("gather", gather)):
            if train:
                g = _with_grads(fn, mcfg.n_offsets)
                rows["grad " + name] = lambda g=g: g(params, valid, frame)
            else:
                rows[name] = torch.no_grad()(lambda fn=fn: fn(params, valid, frame))
    if train:
        render = render_fn(variant)
        proxy = torch.zeros((valid.shape[0], mcfg.n_offsets, 3), device=valid.device)
        rows["render"] = torch.no_grad()(
            lambda: render(params, valid, frame, mcfg, rcfg, bg)[0])
        rows["+ loss"] = torch.no_grad()(
            lambda: frame_loss(params, proxy, valid, state.step, frame, bg, mcfg, rcfg, ocfg,
                               variant)[0])
        rows["+ grad"] = lambda: loss_and_grads(state, frame, bg, mcfg, rcfg, ocfg, variant)
        rows["+ adam"] = lambda: train_step(state, frame, bg, mcfg, rcfg, ocfg,
                                            update_stats=False, variant=variant)
    return rows


def measure(rows: dict, dev: torch.device) -> dict:
    """{row: median ms} of each row as one CUDA graph, timed in turns; on
    the CPU each row runs once and nothing is timed ({})."""
    from lidargs_torch.train.graphs import StaticProgram

    pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None
    programs = {k: StaticProgram(fn, lambda out: out, dev, pool) for k, fn in rows.items()}
    if dev.type != "cuda":
        for p in programs.values():
            p.run()
        return {}
    for p in programs.values():
        for _ in range(WARMUP):
            p.run()
    torch.cuda.synchronize(dev)
    keys = list(programs)
    events = {k: [] for k in keys}
    for r in range(ROUNDS):
        for k in (keys if r % 2 == 0 else keys[::-1]):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            programs[k].run()
            b.record()
            events[k].append((a, b))
    torch.cuda.synchronize(dev)
    return {k: statistics.median(a.elapsed_time(b) for a, b in v) for k, v in events.items()}
