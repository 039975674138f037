"""The street scene, the field and the poses of a cell, made from the seed.

The world is a frozen copy of the port's procedural street
(`lidargs_torch/data/synthetic.py` `make_street_dataset`: building facades
on both sides, parked cars, trees, a cos-incidence-shaded ground), drawn
from `numpy.random.default_rng(world_seed)` on the host in the original's
order; the traffic mix fixes the world, so that every run's seed asks for
the same amount of work.
Its ray casts (`raycast_world`) are rewritten in torch and run on the
device for all frames at once: the numpy original takes about a minute for
50 frames of 64 x 2650 rays. The init cloud is the frames' points in the
world, sampled with replacement (the reader's rule), voxelized as the
port's `voxelize_points` does, and each anchor's initial scales are the log
square root of its mean squared distance to its 3 nearest neighbours.

The field's parameters, in the port's parameter layout, are drawn from a
`torch.Generator` on the device: each anchor's offsets and features and
the four two-layer MLP heads (torch.nn.Linear's uniform init). The
configuration fixes that seed (`field_seed`), as the traffic fixes the
world: a run's own seed orders the work (the frames the training draws,
the densify draws, the poses of the trajectory, the frames checked), so
that every seed asks for the same amount of it. The benchmark hands the
same tensors to the port and to the reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

F32 = torch.float32
F64 = torch.float64


class Pose(NamedTuple):
    """A sensor pose: world->sensor rotation and translation, and the
    sensor's origin in the world (float32, on the device)."""

    w2s_rot: torch.Tensor
    w2s_trans: torch.Tensor
    center: torch.Tensor


class Scene(NamedTuple):
    beams: torch.Tensor          # [H] ascending inclinations, float32
    train: list                  # [(Pose, gt [3, H, W])]
    test: list
    init_points: torch.Tensor    # [N, 3] float32, world


def uniform_beams(fov_up: float, fov: float, H: int) -> np.ndarray:
    """The uniform-FOV beam table, ascending, radians (float32 as the
    original computes it)."""
    j = np.arange(H, dtype=np.float32)
    alpha = (fov_up - j / H * fov) / 180.0 * np.pi
    return np.ascontiguousarray(alpha[::-1])


def street_world(rng: np.random.Generator, n_frames: int):
    """(boxes [B, 6], box albedo [B], spheres [S, 4], albedo [S + 1]) of the
    street, drawn in the original's order."""
    road_len = n_frames * 0.6 + 20
    boxes, box_albedo = [], []
    for side in (-1.0, 1.0):
        x = -10.0
        while x < road_len:
            w = rng.uniform(6.0, 14.0)
            depth_b = rng.uniform(6.0, 12.0)
            h = rng.uniform(4.0, 12.0)
            setback = rng.uniform(8.0, 12.0)
            y0 = side * setback
            y1 = side * (setback + depth_b)
            boxes.append([x, min(y0, y1), 0.0, x + w, max(y0, y1), h])
            box_albedo.append(rng.uniform(0.4, 0.9))
            x += w + rng.uniform(0.5, 3.0)
    for _ in range(n_frames // 4):
        x = rng.uniform(-5, road_len)
        side = rng.choice([-1.0, 1.0])
        y = side * rng.uniform(5.0, 7.0)
        boxes.append([x, y - 1.0, 0.0, x + rng.uniform(3.5, 5.0), y + 1.0,
                      rng.uniform(1.4, 1.9)])
        box_albedo.append(rng.uniform(0.2, 0.6))
    n_trees = n_frames // 3
    spheres = np.stack([
        rng.uniform(-10, road_len, n_trees),
        rng.choice([-1.0, 1.0], n_trees) * rng.uniform(6.0, 8.5, n_trees),
        rng.uniform(2.5, 4.0, n_trees),
        rng.uniform(1.0, 2.0, n_trees),
    ], -1)
    albedo = np.concatenate([[0.35], rng.uniform(0.5, 0.95, n_trees)])
    return np.array(boxes), np.array(box_albedo), spheres, albedo


def ray_grid(H: int, W: int, beams: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] unit rays, float64: row r looks along beam H - 1 - r."""
    rows = torch.arange(H, device=beams.device)
    cols = torch.arange(W, dtype=F64, device=beams.device)
    alpha = beams[H - 1 - rows][:, None]                  # float32, as the original's
    ca, sa = torch.cos(alpha).to(F64), torch.sin(alpha).to(F64)
    beta = -(cols[None, :] - W / 2.0) / W * 2.0 * math.pi
    return torch.stack([ca * torch.cos(beta), ca * torch.sin(beta),
                        sa * torch.ones_like(beta)], -1)


def raycast(origins: torch.Tensor, dirs: torch.Tensor, spheres, albedo, boxes, box_albedo,
            far: float = 75.0):
    """The original's `raycast_world(..., lambertian=True)` for F sensor
    origins [F, 3] at once: (depth, intensity), each [F, H, W] float32.
    Nearest hit of the ground plane, the spheres and the boxes, shaded by
    |n . d| and a range falloff; misses and hits beyond `far` read 0."""
    dev = dirs.device
    o = origins.to(F64)[:, None, None, :]                       # [F, 1, 1, 3]
    d = dirs[None]                                              # [1, H, W, 3]
    n_f = origins.shape[0]
    H, W = dirs.shape[:2]
    inf = torch.full((n_f, H, W), math.inf, dtype=F64, device=dev)
    dz = d[..., 2]
    down = dz < -1e-6
    t_g = torch.where(down, (0.0 - o[..., 2]) / torch.where(down, dz, torch.ones_like(dz)), inf)
    depth = t_g
    mat = torch.where(t_g < math.inf, 0, -1).to(torch.int64)
    cosi = torch.where(t_g < math.inf, dz.abs().expand_as(t_g), torch.ones_like(t_g))
    for i, (cx, cy, cz, r) in enumerate(spheres.tolist()):
        c = torch.tensor([cx, cy, cz], dtype=F64, device=dev)
        oc = o - c
        b = 2.0 * (d * oc).sum(-1)
        cc = (oc * oc).sum(-1) - r * r
        disc = b * b - 4.0 * cc
        t = torch.where(disc > 0, (-b - torch.sqrt(disc.clamp_min(0.0))) / 2.0, inf)
        t = torch.where(t > 0.1, t, inf)
        closer = t < depth
        depth = torch.where(closer, t, depth)
        mat = torch.where(closer, i + 1, mat)
        t_f = torch.where(torch.isfinite(t), t, torch.zeros_like(t))
        n = (o + t_f[..., None] * d - c) / r
        cosi = torch.where(closer, (n * d).sum(-1).abs(), cosi)
    S = len(spheres)
    safe = torch.where(d.abs() > 1e-12, d, torch.full_like(d, 1e-12))
    for j, (x0, y0, z0, x1, y1, z1) in enumerate(boxes.tolist()):
        lo = torch.tensor([x0, y0, z0], dtype=F64, device=dev)
        hi = torch.tensor([x1, y1, z1], dtype=F64, device=dev)
        t_lo, t_hi = (lo - o) / safe, (hi - o) / safe
        t1, t2 = torch.minimum(t_lo, t_hi), torch.maximum(t_lo, t_hi)
        tn, tn_axis = t1.max(-1)
        tf = t2.min(-1).values
        hit = (tn <= tf) & (tn > 0.1)
        t = torch.where(hit, tn, inf)
        closer = t < depth
        depth = torch.where(closer, t, depth)
        mat = torch.where(closer, S + 1 + j, mat)
        cs = torch.gather(d.expand(n_f, H, W, 3), -1, tn_axis[..., None])[..., 0].abs()
        cosi = torch.where(closer, cs, cosi)
    alb = torch.as_tensor(np.concatenate([albedo, box_albedo]), dtype=F64, device=dev)
    inten = torch.where(mat >= 0, alb[mat.clamp_min(0)], torch.zeros_like(depth))
    inten = inten * cosi.clamp(0.05, 1.0)
    inten = inten * (1.0 - depth / (2.0 * far)).clamp(0.2, 1.0)
    drop = (depth > far) | ~torch.isfinite(depth)
    depth = torch.where(drop, torch.zeros_like(depth), depth)
    inten = torch.where(drop, torch.zeros_like(inten), inten)
    return depth.to(F32), inten.to(F32)


def pose_at(x: float, y: float, z: float, yaw: float, dev) -> Pose:
    """The pose of a sensor at (x, y, z), turned by `yaw` about z; the
    world->sensor transform is inverted in float64."""
    l2w = np.eye(4)
    c, s = math.cos(yaw), math.sin(yaw)
    l2w[:3, :3] = [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
    l2w[:3, 3] = [x, y, z]
    w2l = np.linalg.inv(l2w)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return Pose(f32(w2l[:3, :3]), f32(w2l[:3, 3]), f32(l2w[:3, 3]))


def make_scene(seed: int, sensor: dict, scene: dict, dev) -> Scene:
    """The street's frames (poses and ground truth [raydrop, intensity,
    depth]) and its init cloud."""
    H, W = sensor["H"], sensor["W"]
    n_frames = scene["frames"]
    rng = np.random.default_rng(seed)
    boxes, box_albedo, spheres, albedo = street_world(rng, n_frames)
    beams = torch.as_tensor(uniform_beams(sensor["fov_up_deg"], sensor["fov_deg"], H),
                            device=dev)
    dirs = ray_grid(H, W, beams)
    step, z = scene["frame_spacing_m"], scene["sensor_height_m"]
    origins = torch.tensor([[step * i, 0.0, z] for i in range(n_frames)], dtype=F64,
                           device=dev)
    depths, intens = [], []
    for lo in range(0, n_frames, scene.get("cast_batch", 8)):
        d, it = raycast(origins[lo:lo + scene.get("cast_batch", 8)], dirs, spheres, albedo,
                        boxes, box_albedo)
        depths.append(d)
        intens.append(it)
    depth, inten = torch.cat(depths), torch.cat(intens)
    test = set(scene["test_frames"])
    train_frames, test_frames, clouds = [], [], []
    for i in range(n_frames):
        gt = torch.stack([(depth[i] > 0).to(F32), inten[i].clamp(0, 1), depth[i]])
        (test_frames if i in test else train_frames).append(
            (pose_at(step * i, 0.0, z, 0.0, dev), gt))
        hit = depth[i] != 0
        clouds.append(dirs[hit] * depth[i].to(F64)[hit][:, None] + origins[i])
    cloud = torch.cat(clouds)
    sel = np.random.default_rng(seed).choice(cloud.shape[0], scene["init_points"], replace=True)
    return Scene(beams, train_frames, test_frames,
                 cloud[torch.as_tensor(sel, device=dev)].to(F32))


def voxelize(points: torch.Tensor, voxel: float) -> torch.Tensor:
    """Unique voxel-rounded points in lexicographic order, float64 (the
    port's `voxelize_points`)."""
    cells = torch.round(points.to(F64) * (1.0 / voxel))
    order = torch.arange(cells.shape[0], device=cells.device)
    for col in (2, 1, 0):
        order = order[torch.argsort(cells[order, col], stable=True)]
    cells = cells[order]
    new = torch.ones(cells.shape[0], dtype=torch.bool, device=cells.device)
    new[1:] = (cells[1:] != cells[:-1]).any(1)
    return cells[new] * voxel


def knn3_mean_sq(points: torch.Tensor, rows: int = 2048) -> torch.Tensor:
    """[N] mean squared distance of each point to its 3 nearest others,
    from float32 coordinate differences ((dx^2 + dy^2) + dz^2), in blocks
    of `rows` query rows."""
    out = []
    for lo in range(0, points.shape[0], rows):
        q = points[lo:lo + rows]
        diff = q[:, None, :] - points[None, :, :]
        d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + diff[..., 2] * diff[..., 2]
        out.append(torch.topk(d2, 4, dim=1, largest=False).values[:, 1:].sum(1) / 3.0)
    return torch.cat(out)


def mlp_dims(model: dict) -> dict:
    """Input widths of the four heads (no appearance rows)."""
    base = model["feat_dim"] + 3
    return {"mlp_opacity": (base + int(model["add_opacity_dist"]), model["n_offsets"]),
            "mlp_cov": (base + int(model["add_cov_dist"]), 7 * model["n_offsets"]),
            "mlp_color": (base + int(model["add_color_dist"]),
                          (model["color_channel"] - 1) * model["n_offsets"]),
            "mlp_raydrop": (base + int(model["add_color_dist"]), model["n_offsets"])}


def make_field(seed: int, model: dict, init_points: torch.Tensor, field: dict):
    """(params in the port's layout, valid [capacity] bool, voxel size):
    anchors from the voxelized init cloud, their 3-NN log scales, identity
    rotations, opacity 0; each anchor's offsets and features and the heads
    drawn from `seed`."""
    dev = init_points.device
    voxel = field["voxel_size"]
    anchors = voxelize(init_points, voxel).to(F32)
    n, cap, k = anchors.shape[0], model["anchor_capacity"], model["n_offsets"]
    if n > cap:
        raise ValueError(f"{n} anchors exceed the capacity {cap}")
    d2 = knn3_mean_sq(anchors).clamp_min(1e-7)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rows(width, fill=0.0):
        return torch.full((cap, width), fill, dtype=F32, device=dev)

    anchor, scaling = rows(3), rows(6)
    anchor[:n] = anchors
    scaling[:n] = torch.log(torch.sqrt(d2))[:, None]
    rotation = rows(4)
    rotation[:, 0] = 1.0
    offset = torch.zeros((cap, k, 3), dtype=F32, device=dev)
    a = field["offset_range"]
    offset[:n] = torch.empty((n, k, 3), dtype=F32, device=dev).uniform_(-a, a, generator=gen)
    feat = rows(model["feat_dim"])
    feat[:n] = torch.randn((n, model["feat_dim"]), generator=gen, device=dev) * field["feat_std"]
    params = {"anchor": anchor, "offset": offset, "feat": feat, "scaling": scaling,
              "rotation": rotation, "opacity": rows(1)}
    dims = mlp_dims(model)
    hid = model["mlp_hidden"]
    sizes = [(d_in, hid) for d_in, _ in dims.values()] + [(hid, d_out) for _, d_out in dims.values()]
    flat = torch.rand((sum((i + 1) * o for i, o in sizes),), generator=gen, device=dev)
    at = 0
    layers = []
    for d_in, d_out in sizes:
        lim = 1.0 / math.sqrt(d_in)
        w = flat[at:at + d_in * d_out].reshape(d_in, d_out) * (2 * lim) - lim
        at += d_in * d_out
        b = flat[at:at + d_out] * (2 * lim) - lim
        at += d_out
        layers.append({"w": w.contiguous(), "b": b.contiguous()})
    for i, name in enumerate(dims):
        params[name] = {"l1": layers[i], "l2": layers[len(dims) + i]}
    valid = torch.arange(cap, device=dev) < n
    return params, valid, voxel


def novel_poses(seed: int, scene: dict, traffic: dict, dev) -> list:
    """The re-simulation trajectory: `poses` poses between the training
    poses along the street, each offset sideways by up to `lateral_m` and
    turned by up to `yaw_deg`, drawn from the seed."""
    rng = np.random.default_rng([seed, 1])
    n = traffic["poses"]
    span = scene["frame_spacing_m"] * (scene["frames"] - 1)
    xs = np.sort(rng.uniform(0.0, span, n))
    ys = rng.uniform(-traffic["lateral_m"], traffic["lateral_m"], n)
    yaws = np.radians(rng.uniform(-traffic["yaw_deg"], traffic["yaw_deg"], n))
    z = scene["sensor_height_m"]
    return [pose_at(float(x), float(y), z, float(a), dev) for x, y, a in zip(xs, ys, yaws)]
