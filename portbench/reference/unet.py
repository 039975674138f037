"""LiDAR4D's ray-drop refinement UNet, the reference's forward.

Zheng et al., LiDAR4D (CVPR 2024, arXiv:2404.02742), as LiDAR-GS carries it
(`scene/unet.py:139-171`): a 1x1 in-conv to `channels`; four levels of 2x2
max-pool and a pre-activation double conv (BatchNorm-ReLU-conv3x3, twice),
the channels doubling to 8 x `channels` (the fourth keeps them); eight-head
self-attention over the bottom grid, added to its input; four levels of
bilinear x2, the skip concatenated before the upsampled map, and a double
conv; BatchNorm-ReLU and a 1x1 out-conv under a sigmoid. Its input is the
[ray drop, intensity, depth / depth scale] image, zero-padded at the bottom
and right to multiples of 16 and cropped back after.

Plain PyTorch in float32: `F.conv2d`, BatchNorm as an explicit mean and
biased variance, `F.interpolate`, attention as matmul, softmax, matmul.
Weights are the JAX package's pytree of the refiner (`inc/w`,
`down1/bn1/scale`, ...; convolutions OIHW). It loads nothing of the port
or of JAX. Run it under `check.precision` (TF32 off, on for the control),
as `check.reference_render` does.

Departures from the original, both as the port runs it:
  * BatchNorm normalizes by the statistics of the frame itself (mean and
    biased variance over N, H, W; eps 1e-5) at render time too, where the
    original's eval mode reads running statistics: the port keeps none.
  * The x2 upsampling is bilinear with half-pixel centres
    (`align_corners=False`), the rule both packages compute, where the
    original aligns the corners.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
LEVELS = 4                     # max-pool levels: the padded sides are multiples of 2**LEVELS


def double_conv_spec(c_in: int, c_out: int, c_mid: int) -> List[Tuple[str, tuple]]:
    return [("bn1/scale", (c_in,)), ("bn1/bias", (c_in,)),
            ("conv1/w", (c_mid, c_in, 3, 3)),
            ("bn2/scale", (c_mid,)), ("bn2/bias", (c_mid,)),
            ("conv2/w", (c_out, c_mid, 3, 3))]


def blocks(c: int) -> list:
    """(name, c_in, c_out, c_mid) of the double convs, down then up."""
    return [("down1", c, 2 * c, 2 * c), ("down2", 2 * c, 4 * c, 4 * c),
            ("down3", 4 * c, 8 * c, 8 * c), ("down4", 8 * c, 8 * c, 8 * c),
            ("up1", 16 * c, 4 * c, 16 * c), ("up2", 8 * c, 2 * c, 8 * c),
            ("up3", 4 * c, c, 4 * c), ("up4", 2 * c, c, 2 * c)]


def weight_spec(in_channels: int, channels: int, out_channels: int) -> List[Tuple[str, tuple]]:
    """(path, shape) of every weight, in the module order of the original."""
    c = channels
    spec = [("inc/w", (c, in_channels, 1, 1)), ("inc/b", (c,))]
    for name, ci, co, cm in blocks(c)[:4]:
        spec += [(f"{name}/{k}", s) for k, s in double_conv_spec(ci, co, cm)]
    spec += [("attn/norm/scale", (8 * c,)), ("attn/norm/bias", (8 * c,)),
             ("attn/qkv/w", (24 * c, 8 * c, 1, 1)), ("attn/proj/w", (8 * c, 8 * c, 1, 1))]
    for name, ci, co, cm in blocks(c)[4:]:
        spec += [(f"{name}/{k}", s) for k, s in double_conv_spec(ci, co, cm)]
    spec += [("out_bn/scale", (c,)), ("out_bn/bias", (c,)),
             ("outc/w", (out_channels, c, 1, 1)), ("outc/b", (out_channels,))]
    return spec


def draw_weights(gen: torch.Generator, in_channels: int, channels: int,
                 out_channels: int) -> dict:
    """A nested dict of CPU tensors by `weight_spec`, drawn from `gen` in
    order: a convolution's weight and bias U(+-1/sqrt(fan_in)) (torch's and
    JAX's init), a BatchNorm's scale U(0.5, 1.5) and bias U(-0.5, 0.5), so
    that the check sees them move the output."""
    tree: dict = {}
    fan_in = {}
    for path, shape in weight_spec(in_channels, channels, out_channels):
        mod, leaf = path.rsplit("/", 1)
        if leaf == "w":
            fan_in[mod] = math.prod(shape[1:])
        if leaf in ("w", "b"):
            lo, hi = -1.0 / math.sqrt(fan_in[mod]), 1.0 / math.sqrt(fan_in[mod])
        else:
            lo, hi = (0.5, 1.5) if leaf == "scale" else (-0.5, 0.5)
        node = tree
        for p in mod.split("/"):
            node = node.setdefault(p, {})
        node[leaf] = torch.empty(shape).uniform_(lo, hi, generator=gen)
    return tree


def conv(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Stride 1, zero padding that keeps the size."""
    return F.conv2d(x, p["w"], p.get("b"), padding=p["w"].shape[-1] // 2)


def batch_norm(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Normalized by the mean and biased variance over (N, H, W)."""
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(0, 2, 3), keepdim=True)
    y = (x - mean) / torch.sqrt(var + BN_EPS)
    return y * p["scale"][None, :, None, None] + p["bias"][None, :, None, None]


def double_conv(x: torch.Tensor, p: dict) -> torch.Tensor:
    h = conv(torch.relu(batch_norm(x, p["bn1"])), p["conv1"])
    return conv(torch.relu(batch_norm(h, p["bn2"])), p["conv2"])


def attention(x: torch.Tensor, p: dict, heads: int) -> torch.Tensor:
    """x + proj(softmax(q k^T / sqrt(d)) v) over the H x W tokens, each of
    `heads` heads of d = C / heads channels; the heads' results [N, heads,
    HW, d] are read back as [N, H, W, C] (the original's reshape, which
    mixes heads and tokens) before the projection."""
    N, C, H, W = x.shape
    d = C // heads
    q, k, v = conv(batch_norm(x, p["norm"]), p["qkv"]).chunk(3, dim=1)
    q = q.reshape(N, heads, d, H * W).transpose(2, 3)
    k = k.reshape(N, heads, d, H * W)
    v = v.reshape(N, heads, d, H * W).transpose(2, 3)
    w = torch.softmax(torch.matmul(q, k) * (d ** -0.5), dim=-1)
    h = torch.matmul(w, v).reshape(N, H, W, C).permute(0, 3, 1, 2)
    return x + conv(h, p["proj"])


def up(x: torch.Tensor, skip: torch.Tensor, p: dict) -> torch.Tensor:
    """Bilinear x2, zero-padded to the skip's size (split evenly), the skip
    first in the concatenation, then the double conv."""
    u = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
    dy, dx = skip.shape[2] - u.shape[2], skip.shape[3] - u.shape[3]
    u = F.pad(u, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
    return double_conv(torch.cat([skip, u], dim=1), p)


def unet(x: torch.Tensor, p: dict, heads: int) -> torch.Tensor:
    """[N, in, H, W] -> [N, out, H, W], H and W multiples of 16."""
    x0 = conv(x, p["inc"])
    x1 = double_conv(F.max_pool2d(x0, 2), p["down1"])
    x2 = double_conv(F.max_pool2d(x1, 2), p["down2"])
    x3 = double_conv(F.max_pool2d(x2, 2), p["down3"])
    x4 = attention(double_conv(F.max_pool2d(x3, 2), p["down4"]), p["attn"], heads)
    h = up(x4, x3, p["up1"])
    h = up(h, x2, p["up2"])
    h = up(h, x1, p["up3"])
    h = up(h, x0, p["up4"])
    return torch.sigmoid(conv(torch.relu(batch_norm(h, p["out_bn"])), p["outc"]))


def padded(n: int) -> int:
    """`n` rounded up to a multiple of 2**LEVELS."""
    q = 2 ** LEVELS
    return -(-n // q) * q


def refine_raydrop(p: dict, raydrop: torch.Tensor, intensity: torch.Tensor,
                   depth_scaled: torch.Tensor, heads: int) -> torch.Tensor:
    """[H, W] images -> the refined ray-drop probability [H, W]: the three
    stacked, zero-padded at the bottom and right, the UNet, cropped."""
    H, W = raydrop.shape
    x = torch.stack([raydrop, intensity, depth_scaled])
    x = F.pad(x, (0, padded(W) - W, 0, padded(H) - H))
    return unet(x[None], p, heads)[0, 0, :H, :W]
