"""The layout of the ranks: a `data` x `tile` grid, one device per process.

Counterpart of `lidargs_tpu/parallel/mesh.py`. The JAX package puts N
devices of one process on a `Mesh` and lets `shard_map` and `psum` work
over its axes; PyTorch has no such mesh inside a process, so the port runs
one process per device (`parallel/runtime.py`) and the mesh describes the
ranks of `torch.distributed`: rank r sits at (r // tile, r % tile), data
major as the JAX package reshapes its device list. Frames are split over
the data axis and gradients summed along it (`parallel/shard.py`); a
frame's anchors and tiles are split over the tile axis
(`parallel/sharded_render.py`).

`replicated`, `frame_sharded` and `tile_sharding` (GSPMD shardings) are not
carried: without one program over many devices they mean nothing, and
every rank holds its own tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch.distributed as dist

from .collectives import rank, world


@dataclass(frozen=True)
class Mesh:
    """A data x tile grid of ranks, this rank's place in it, and the
    process groups of its two axes (built once, by `make_mesh`)."""

    data: int
    tile: int
    data_index: int          # this rank's coordinate on the data axis
    tile_index: int          # ... and on the tile axis
    data_group: Any = None   # the ranks at this tile_index: gradients are summed over them
    tile_group: Any = None   # the ranks at this data_index: one frame's anchors and tiles

    @property
    def shape(self) -> dict:
        return {"data": self.data, "tile": self.tile}

    @property
    def size(self) -> int:
        return self.data * self.tile


def make_mesh(data: int = 1, tile: int = 1) -> Mesh:
    """The mesh over every rank of the initialized `torch.distributed`
    world (one process without it: only 1x1). Every rank must call it, in
    the same order as its other group-building calls."""
    n, need = world(), data * tile
    if need > n:
        raise ValueError(
            f"mesh {data}x{tile} needs {need} devices, have {n}\n"
            f"lidargs_torch drives one device per process: launch {need} processes "
            "(parallel/runtime.py init_runtime, the CLI's --num_processes)")
    if need < n:
        raise ValueError(f"mesh {data}x{tile} covers {need} of {n} ranks; "
                         "the port's mesh spans every rank")
    d, t = divmod(rank(), tile)
    if n == 1:
        return Mesh(data, tile, d, t)
    data_group = tile_group = None
    for tt in range(tile):
        g = dist.new_group([dd * tile + tt for dd in range(data)])
        data_group = g if tt == t else data_group
    for dd in range(data):
        g = dist.new_group([dd * tile + tt for tt in range(tile)])
        tile_group = g if dd == d else tile_group
    return Mesh(data, tile, d, t, data_group, tile_group)
