"""Visualization helpers: depth/intensity -> RGB colormaps and a PNG
writer.

Counterpart of `lidargs_tpu/utils/visualize.py` (the reference's
`utils/visualize_utils.py` and its colormap): NumPy only, host side, no
cv2/matplotlib/imageio dependency.
"""
from __future__ import annotations

import numpy as np

# 16-knot approximation of the turbo colormap (Google AI blog, public
# reference values); linearly interpolated.
_TURBO = np.array([
    [0.18995, 0.07176, 0.23217], [0.25107, 0.25237, 0.63374],
    [0.27628, 0.42118, 0.89123], [0.25862, 0.57958, 0.99876],
    [0.15844, 0.73551, 0.92305], [0.09267, 0.86554, 0.76460],
    [0.19659, 0.94901, 0.59466], [0.42778, 0.99419, 0.38575],
    [0.64362, 0.98999, 0.23356], [0.80473, 0.92452, 0.20459],
    [0.93301, 0.81236, 0.22667], [0.99314, 0.67408, 0.20348],
    [0.98000, 0.49291, 0.12849], [0.89888, 0.30855, 0.06059],
    [0.76695, 0.15541, 0.01946], [0.47960, 0.01583, 0.01055],
])


def colormap(x: np.ndarray, vmin: float = None, vmax: float = None,
             cmap: str = "turbo") -> np.ndarray:
    """[H, W] scalar field -> [H, W, 3] float RGB in [0, 1]."""
    x = np.asarray(x, np.float64)
    lo = np.nanmin(x) if vmin is None else vmin
    hi = np.nanmax(x) if vmax is None else vmax
    t = np.clip((x - lo) / max(hi - lo, 1e-12), 0.0, 1.0)
    if cmap == "gray":
        return np.repeat(t[..., None], 3, axis=-1)
    knots = _TURBO
    pos = t * (len(knots) - 1)
    i0 = np.clip(pos.astype(np.int64), 0, len(knots) - 2)
    frac = (pos - i0)[..., None]
    return knots[i0] * (1 - frac) + knots[i0 + 1] * frac


def depth_to_rgb(depth: np.ndarray, vmax: float = 80.0) -> np.ndarray:
    """Turbo-colormapped range image (train.py:318-338 TB images)."""
    return colormap(depth, 0.0, vmax)


def intensity_to_rgb(intensity: np.ndarray) -> np.ndarray:
    return colormap(intensity, 0.0, 1.0)


def save_image(path: str, rgb01: np.ndarray) -> None:
    """Write an RGB float image in [0, 1] as PNG (pure-python fallback via
    the minimal PNG encoder below; no imageio/cv2 needed)."""
    img = (np.clip(rgb01, 0, 1) * 255).astype(np.uint8)
    _write_png(path, img)


def _write_png(path: str, img: np.ndarray) -> None:
    import struct
    import zlib

    h, w = img.shape[:2]
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(
            ">I", zlib.crc32(c) & 0xFFFFFFFF)

    hdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", hdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def normals_from_range(depth: np.ndarray, beams: np.ndarray) -> np.ndarray:
    """[H, W] range image -> [H, W, 3] screen-space normals via central
    differences of back-projected positions (visualize_utils.py:120-153,
    adapted to the spherical range-view camera)."""
    H, W = depth.shape
    rows = np.arange(H)
    cols = np.arange(W)
    alpha = np.asarray(beams)[H - 1 - rows][:, None]
    beta = -(cols[None, :] - W / 2.0) / W * 2.0 * np.pi
    d = np.asarray(depth, np.float64)
    x = d * np.cos(alpha) * np.cos(beta)
    y = d * np.cos(alpha) * np.sin(beta)
    z = d * np.sin(alpha)
    p = np.stack([x, y, z], -1)
    du = np.zeros_like(p)
    dv = np.zeros_like(p)
    du[:, 1:-1] = p[:, 2:] - p[:, :-2]
    dv[1:-1, :] = p[2:, :] - p[:-2, :]
    n = np.cross(du, dv)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(norm, 1e-12)
    # orient toward the sensor
    flip = np.sum(n * p, axis=-1, keepdims=True) > 0
    n = np.where(flip, -n, n)
    n[d <= 0] = 0.0
    return n


def normal_to_rgb(normals: np.ndarray) -> np.ndarray:
    return (normals + 1.0) * 0.5
