"""A cell of the benchmark cut to a size the CPU tests can hold: the real
configuration, traffic and limits files with the sizes overridden."""
from __future__ import annotations

import copy

from portbench import registry

SENSOR = {"H": 8, "W": 256}
MODEL = {"anchor_capacity": 2048, "grow_src_cap": 512, "grow_cap_per_level": 128}
RASTER = {"max_visible": 8192, "tile_capacity": 64}
OPT = {"update_interval": 5}
SCENE = {"frames": 6, "test_frames": [], "init_points": 3000}
FIELD = {"voxel_size": 0.6}
TRAFFIC = {"poses": 6, "checked_frames": 2, "counted_frames": 2, "traced": 4,
           "warm_iterations": 10, "warm_frames": 6}


def tiny_cell(name: str, root=registry.ROOT, **traffic):
    """The workload `name` of `root`'s BENCHMARK.json at the tiny size."""
    cell = registry.load_cell(name, root)
    cfg = copy.deepcopy(cell.config)
    cfg["sensor"].update(SENSOR)
    cfg["model"].update(MODEL)
    cfg["raster"].update(RASTER)
    cfg["opt"].update(OPT)
    cfg["field"].update(FIELD)
    t = copy.deepcopy(cell.traffic)
    t["scene"].update(SCENE)
    t.update({k: v for k, v in TRAFFIC.items() if k in t}, **traffic)
    return cell._replace(config=cfg, traffic=t)
