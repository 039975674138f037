"""Synthetic scenes for tests and for the on-card smoke run.

Everything is drawn with numpy from a seed, so the same arrays can be fed
to this package and to the JAX package alike.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import ModelConfig, RasterConfig
from ..lidar.beams import uniform_beam_inclinations
from ..models.field import init_field_params
from ..ops.projection import Splats, preprocess_gaussians
from .device import resolve_device


class SyntheticScene(NamedTuple):
    """Random gaussians as float32 numpy arrays (mask is bool)."""

    means3d: np.ndarray      # [n,3]
    scales: np.ndarray       # [n,3]
    quats: np.ndarray        # [n,4] normalized (r,x,y,z)
    opacities: np.ndarray    # [n]
    feat: np.ndarray         # [n,C]
    mask: np.ndarray         # [n]
    w2s_rot: np.ndarray      # [3,3]
    w2s_trans: np.ndarray    # [3]
    beams: np.ndarray        # [H] ascending
    W: int


def make_scene(seed: int, n: int = 256, H: int = 32, W: int = 256,
               r_min: float = 3.0, r_max: float = 60.0, scale_px: float = 2.0,
               channels: int = 2) -> SyntheticScene:
    """Gaussians scattered over the sensor's panorama, inside the beam FOV,
    sized to span about `scale_px` pixels at their range."""
    rng = np.random.default_rng(seed)
    beams = uniform_beam_inclinations(12.0, 24.0, H).astype(np.float32)
    az = rng.uniform(-np.pi, np.pi, n)
    el = rng.uniform(float(beams[1]), float(beams[-2]), n)
    r = rng.uniform(r_min, r_max, n)
    means = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                      r * np.sin(el)], -1)
    base = r * np.tan(2.0 * np.pi / W) * scale_px
    scales = base[:, None] * rng.uniform(0.5, 2.0, (n, 3))
    q = rng.normal(size=(n, 4))
    quats = q / np.linalg.norm(q, axis=-1, keepdims=True)
    f32 = lambda x: np.ascontiguousarray(x, np.float32)
    return SyntheticScene(
        means3d=f32(means), scales=f32(scales), quats=f32(quats),
        opacities=f32(rng.uniform(0.3, 0.95, n)),
        feat=f32(rng.uniform(0.0, 1.0, (n, channels))),
        mask=np.ones((n,), bool),
        w2s_rot=np.eye(3, dtype=np.float32),
        w2s_trans=np.zeros(3, np.float32),
        beams=beams, W=W,
    )


def scene_splats(sc: SyntheticScene, cfg: RasterConfig, device="cuda") -> Splats:
    """The scene's gaussians projected into its sensor (`preprocess_gaussians`)."""
    dev = resolve_device(device)
    t = lambda x: torch.as_tensor(x, device=dev)
    return preprocess_gaussians(t(sc.means3d), t(sc.scales), t(sc.quats), t(sc.opacities),
                                t(sc.feat), t(sc.mask), t(sc.w2s_rot), t(sc.w2s_trans),
                                t(sc.beams), sc.W, cfg)


def shell_anchors(n: int, feat_dim: int, seed: int = 0) -> dict:
    """The render benchmark's synthetic street-like scene: `n` anchors on
    the sensor's visible shell (azimuth all round, elevation -20..2 deg,
    range 4..75 m), log-scales growing with range, random features.
    Returns numpy rows for the first `n` entries of `anchor`, `scaling`
    and `feat`."""
    rng = np.random.default_rng(seed)
    az = rng.uniform(-np.pi, np.pi, n)
    el = rng.uniform(np.radians(-20.0), np.radians(2.0), n)
    r = rng.uniform(4.0, 75.0, n)
    pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                    r * np.sin(el)], -1)
    scale = np.log(np.clip(r * 0.004, 0.02, 0.5))
    return {
        "anchor": pts.astype(np.float32),
        "scaling": np.repeat(scale[:, None], 6, axis=1).astype(np.float32),
        "feat": (rng.normal(size=(n, feat_dim)) * 0.3).astype(np.float32),
    }


def shell_field(mcfg: ModelConfig, n: int, seed: int = 0, device="cuda"):
    """init_field_params (heads from a generator seeded with `seed`) with
    the shell anchors of `shell_anchors` in its first `n` rows.
    Returns (params, valid)."""
    params = init_field_params(mcfg, generator=torch.Generator().manual_seed(seed),
                               device=device)
    rows = shell_anchors(n, mcfg.feat_dim, seed)
    dev = params["anchor"].device
    for name, arr in rows.items():
        params[name][:n] = torch.from_numpy(arr).to(dev)
    valid = torch.arange(mcfg.anchor_capacity, device=dev) < n
    return params, valid


def assert_close_up_to_flips(got, want, atol: float, flip_atol: float,
                             max_flip_frac: float = 0.01, what: str = "") -> None:
    """Two renders agree: every element within `atol`, except at most
    `max_flip_frac` of them (and at least 2), which stay within `flip_atol`.

    The exceptions are pixels whose front-to-back walk stops one instance
    apart: a pixel stops at the first instance with T * (1 - alpha) < 1e-4,
    and two opaque instances (alpha clamped at 0.99) put T * (1 - alpha)
    right at that threshold, so an ulp of reassociation in T decides. The
    instance at stake weighs alpha * T <= ~1e-2 in the features and T."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), f"{what}: non-finite values"
    d = np.abs(got.astype(np.float64) - want)
    n_far = int((d > atol).sum())
    allowed = max(2, int(max_flip_frac * d.size))
    assert n_far <= allowed, (
        f"{what}: {n_far} of {d.size} elements beyond {atol:g} (allowed {allowed}), "
        f"max {d.max():.3g}")
    assert d.max() <= flip_atol, f"{what}: max |d| {d.max():.3g} beyond {flip_atol:g}"


def one_torch_thread():
    """PyTorch on one thread until the generator is closed, then the count
    it had before: the body of the module-scoped autouse fixture that every
    `tests/test_torch_*.py` file declares (`yield from
    one_torch_thread()`).

    Several test processes share the machine's cores, each at PyTorch's
    default of one thread per core, so they oversubscribe it many times
    over; and with several threads, about one fresh process in twenty that
    had run the JAX pipeline first computed one worker thread's share of
    its first plain composite wrong (up to 2.5e-4 in T), which none of 80
    did on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def sensor_poses(n: int, seed: int = 0) -> list:
    """`n` lidar->world 4x4 poses near the origin: a yaw and a small shift
    each, as a car moving through the scene would give."""
    rng = np.random.default_rng(seed)
    poses = []
    for _ in range(n):
        yaw = rng.uniform(-np.pi, np.pi)
        c, s = np.cos(yaw), np.sin(yaw)
        pose = np.eye(4)
        pose[:3, :3] = [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
        pose[:3, 3] = rng.uniform(-1.0, 1.0, 3) * [2.0, 2.0, 0.2]
        poses.append(pose)
    return poses
