"""Beam-inclination tables.

Semantics match the reference's `utils/lidar_utils.py:10-31,296-299`:
tables are ascending (lowest beam first); row r of the range image maps to
beam index H-1-r (row 0 = highest inclination).
"""
from __future__ import annotations

import numpy as np


def uniform_beam_inclinations(fov_up: float, fov: float, H: int) -> np.ndarray:
    """Uniform-FOV table (KITTI-style). Angles in degrees; returns radians,
    ascending. Mirrors `get_beam_inclinations` (`utils/lidar_utils.py:296-299`)."""
    j = np.arange(H, dtype=np.float32)
    alpha = (fov_up - j / H * fov) / 180.0 * np.pi
    return np.ascontiguousarray(alpha[::-1])


def kitti_beam_inclinations(H: int = 66) -> np.ndarray:
    """The reference's KITTI default: get_beam_inclinations(2.0, 26.9, H)
    (`scene/dataset_readers.py:362`)."""
    return uniform_beam_inclinations(2.0, 26.9, H)


def helios_beam_inclinations() -> np.ndarray:
    """RoboSense Helios 5515 32-beam profile, the reference's
    `cal_beam_inclinations` (`utils/lidar_utils.py:10-31`): piecewise-linear
    coverage of [-55, 15] degrees, ascending, radians."""
    degs: list[float] = []
    degs += list(np.linspace(-55, -10, num=15, endpoint=False))
    degs += list(np.linspace(-10, -8, num=1, endpoint=False))
    degs += list(np.linspace(-8, 4, num=9, endpoint=False))
    degs += list(np.linspace(4, 7, num=2, endpoint=False))
    degs += list(np.linspace(7, 15, num=5))
    return np.radians(np.asarray(degs, dtype=np.float64))
