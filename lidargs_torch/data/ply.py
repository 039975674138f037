"""Minimal binary-little-endian PLY I/O (no plyfile dependency).

Counterpart of `lidargs_tpu/data/ply.py`, host-side numpy that writes the
same bytes, so point clouds and anchor snapshots load in either package.
It covers the reference's two uses: init point clouds and anchor-model
snapshots. The anchor attribute layout matches the reference's
construct_list_of_attributes: x,y,z,nx,ny,nz,f_offset_*,f_anchor_feat_*,
opacity,scale_0..5,rot_0..3.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def write_ply(path: str, fields: Dict[str, np.ndarray]) -> None:
    """fields: name -> [N] float32/uint8 column, written in dict order."""
    n = len(next(iter(fields.values())))
    dtype_map = {np.dtype("float32"): "float", np.dtype("uint8"): "uchar"}
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    cols = []
    for name, col in fields.items():
        col = np.ascontiguousarray(col)
        assert col.shape == (n,), (name, col.shape)
        header.append(f"property {dtype_map[col.dtype]} {name}")
        cols.append((name, col))
    header.append("end_header")

    rec = np.rec.fromarrays(
        [c for _, c in cols], names=[name for name, _ in cols]
    )
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())


def read_ply(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode("ascii").splitlines()
    assert header[0].strip() == "ply"
    fmt = [l for l in header if l.startswith("format")][0].split()[1]
    assert fmt == "binary_little_endian", fmt

    n = None
    props = []
    type_map = {
        "float": "<f4", "float32": "<f4", "double": "<f8",
        "uchar": "u1", "uint8": "u1", "int": "<i4", "uint": "<u4",
    }
    for line in header:
        parts = line.split()
        if parts[0] == "element" and parts[1] == "vertex":
            n = int(parts[2])
        elif parts[0] == "property" and n is not None:
            props.append((parts[2], type_map[parts[1]]))

    rec = np.frombuffer(data[head_end:], dtype=np.dtype(props), count=n)
    return {name: np.ascontiguousarray(rec[name]) for name, _ in props}


def write_point_cloud(path: str, points: np.ndarray, colors: np.ndarray | None = None):
    """storePly layout: xyz + zero normals + uint8 rgb."""
    n = len(points)
    points = np.asarray(points, np.float32)
    colors = (
        np.zeros((n, 3), np.uint8) if colors is None else np.asarray(colors, np.uint8)
    )
    zeros = np.zeros(n, np.float32)
    fields = {
        "x": points[:, 0], "y": points[:, 1], "z": points[:, 2],
        "nx": zeros, "ny": zeros, "nz": zeros,
        "red": colors[:, 0], "green": colors[:, 1], "blue": colors[:, 2],
    }
    write_ply(path, fields)


def read_point_cloud(path: str) -> np.ndarray:
    f = read_ply(path)
    return np.stack([f["x"], f["y"], f["z"]], -1).astype(np.float32)


def write_anchor_model(path: str, anchor, offset, feat, scaling, rotation, opacity):
    """Reference-compatible anchor snapshot (gaussian_model.py:489-506):
    offsets flattened [k*3] then feats, opacity, 6 scales, 4 rots."""
    n, k, _ = offset.shape
    zeros = np.zeros(n, np.float32)
    fields = {
        "x": anchor[:, 0], "y": anchor[:, 1], "z": anchor[:, 2],
        "nx": zeros, "ny": zeros, "nz": zeros,
    }
    off = offset.reshape(n, k * 3)
    for i in range(k * 3):
        fields[f"f_offset_{i}"] = off[:, i]
    for i in range(feat.shape[1]):
        fields[f"f_anchor_feat_{i}"] = feat[:, i]
    fields["opacity"] = opacity[:, 0]
    for i in range(6):
        fields[f"scale_{i}"] = scaling[:, i]
    for i in range(4):
        fields[f"rot_{i}"] = rotation[:, i]
    fields = {k2: np.asarray(v, np.float32) for k2, v in fields.items()}
    write_ply(path, fields)


def read_anchor_model(path: str):
    f = read_ply(path)
    anchor = np.stack([f["x"], f["y"], f["z"]], -1)
    n_off = sum(1 for k in f if k.startswith("f_offset_"))
    n_feat = sum(1 for k in f if k.startswith("f_anchor_feat_"))
    offset = np.stack([f[f"f_offset_{i}"] for i in range(n_off)], -1)
    offset = offset.reshape(len(anchor), n_off // 3, 3)
    feat = np.stack([f[f"f_anchor_feat_{i}"] for i in range(n_feat)], -1)
    scaling = np.stack([f[f"scale_{i}"] for i in range(6)], -1)
    rotation = np.stack([f[f"rot_{i}"] for i in range(4)], -1)
    opacity = f["opacity"][:, None]
    return anchor, offset, feat, scaling, rotation, opacity
