"""LPIPS (VGG-16) perceptual distance.

Counterpart of `lidargs_tpu/train/lpips.py`, with its quirks kept: the
inputs go to the scaling layer as they are (the reference calls
`lpips_fn(render, gt)` on [0, 1] images without `normalize=True`); the
shift (-.030, -.088, -.188) and scale (.458, .448, .450) are float32; VGG-16
features are tapped after relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3,
unit-normalized over channels with eps = 1e-10 added after the square root;
the squared differences go through the per-layer 1x1 "lin" convolutions
and a spatial mean, summed over the five layers. The max-pools floor odd
sizes (2650 -> 1325 -> 662 -> 331 -> 165 columns).

An image needs at least 16 rows and columns: four pools leave VGG's fifth
block an empty map below that (where the JAX package returns NaN, `lpips`
raises).

Pretrained weights cannot be fetched here: `tools/convert_lpips_weights.py`
writes them (torchvision's VGG16 IMAGENET1K_V1 convolutions and the lpips
v0.1 lin weights) into an npz of `conv{i}_w`, `conv{i}_b`, `lin{i}_w`
arrays, which `load_lpips_params` reads as it is; the CLI takes its path
as `--lpips_weights`.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import resolve_device

# torchvision VGG16 `.features`: conv widths, "M" a 2x2 max-pool
_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512]
_N_CONVS = 13
_N_LAYERS = 5
LIN_CHANNELS = (64, 128, 256, 512, 512)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)
# conv index (counting convs only) after whose ReLU a feature is tapped
_TAP_AFTER = (1, 3, 6, 9, 12)

Params = Dict[str, List[np.ndarray]]


def random_lpips_params(seed: int = 0) -> Params:
    """Random parameters of the right shapes, from a numpy seed: conv weights
    and biases normal x 0.1, lin weights uniform in [0, 0.2) (the JAX
    package's draws, by numpy)."""
    rng = np.random.default_rng(seed)
    params: Params = {"conv_w": [], "conv_b": [], "lin_w": []}
    cin = 3
    for v in _VGG_CFG:
        if v == "M":
            continue
        params["conv_w"].append((rng.standard_normal((v, cin, 3, 3)) * 0.1).astype(np.float32))
        params["conv_b"].append((rng.standard_normal(v) * 0.1).astype(np.float32))
        cin = v
    for nc in LIN_CHANNELS:
        params["lin_w"].append(rng.uniform(0.0, 0.2, (1, nc, 1, 1)).astype(np.float32))
    return params


def load_lpips_params(path: str) -> Params:
    """The npz written by `tools/convert_lpips_weights.py`, read as it is."""
    with np.load(path) as z:
        return {"conv_w": [z[f"conv{i}_w"] for i in range(_N_CONVS)],
                "conv_b": [z[f"conv{i}_b"] for i in range(_N_CONVS)],
                "lin_w": [z[f"lin{i}_w"] for i in range(_N_LAYERS)]}


def save_lpips_params(path: str, params: Params) -> None:
    """`params` in the converter's npz layout."""
    arrays = {}
    for i, (w, b) in enumerate(zip(params["conv_w"], params["conv_b"])):
        arrays[f"conv{i}_w"], arrays[f"conv{i}_b"] = np.asarray(w), np.asarray(b)
    for i, w in enumerate(params["lin_w"]):
        arrays[f"lin{i}_w"] = np.asarray(w)
    np.savez(path, **arrays)


class LPIPS(nn.Module):
    """The VGG-16 taps and the lin layers as fixed buffers (named as the
    converter's npz keys); `forward(x, y)` maps an [N,3,H,W] pair to [N]
    distances."""

    def __init__(self, params: Params):
        super().__init__()
        f32 = lambda a: torch.from_numpy(np.array(a, np.float32))
        for i in range(_N_CONVS):
            self.register_buffer(f"conv{i}_w", f32(params["conv_w"][i]))
            self.register_buffer(f"conv{i}_b", f32(params["conv_b"][i]))
        for i in range(_N_LAYERS):
            self.register_buffer(f"lin{i}_w", f32(params["lin_w"][i]))
        self.register_buffer("shift", torch.from_numpy(_SHIFT)[None, :, None, None])
        self.register_buffer("scale", torch.from_numpy(_SCALE)[None, :, None, None])

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """[N,3,H,W] -> the five tapped post-ReLU feature maps."""
        feats, ci = [], 0
        for v in _VGG_CFG:
            if v == "M":
                x = F.max_pool2d(x, 2)
                continue
            x = torch.relu(F.conv2d(x, getattr(self, f"conv{ci}_w"),
                                    getattr(self, f"conv{ci}_b"), padding=1))
            if ci in _TAP_AFTER:
                feats.append(x)
            ci += 1
        return feats

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[-2:]
        if H < 16 or W < 16:
            raise ValueError(f"LPIPS needs at least 16x16 pixels, got {H}x{W}: four "
                             "max-pools leave VGG's fifth block an empty map")
        fx = self.features((x - self.shift) / self.scale)
        fy = self.features((y - self.shift) / self.scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            total = total + F.conv2d(d, getattr(self, f"lin{i}_w")).mean(dim=(1, 2, 3))
        return total


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt((x * x).sum(dim=1, keepdim=True)) + eps)


def lpips_net(params: Params, device="cuda") -> LPIPS:
    """The LPIPS module on `device` (the card unless the caller passes the
    CPU)."""
    return LPIPS(params).to(resolve_device(device))


def lpips(net: LPIPS, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[N,3,H,W] pair -> [N] LPIPS distances; the inputs go to the scaling
    layer as they are."""
    return net(x, y)


def lpips_single(net: LPIPS, img_a: torch.Tensor, img_b: torch.Tensor) -> torch.Tensor:
    """One [C,H,W] or [H,W] pair -> a scalar; a single channel is tiled to
    the three RGB channels (a LiDAR intensity image as the reference's
    saved PNG renders carry it)."""
    def to3(img):
        if img.dim() == 2:
            img = img[None]
        if img.shape[0] == 1:
            img = img.repeat(3, 1, 1)
        return img[None, :3]

    return net(to3(img_a), to3(img_b))[0]
