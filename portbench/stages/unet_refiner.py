"""The ray-drop refiner as a stage of the re-simulated frame: LiDAR4D's
attention UNet (`reference/unet.py`) replaces each frame's ray drop inside
the port's render program.

The configuration's top-level `"refiner"` group gives its sizes
(`in_channels`, `channels`, `out_channels`, `heads`) and `depth_scale`, the
metres that the depth is divided by on its way in.

  * `draw`: the weights, a CPU generator seeded with the run's seed
    (`reference/unet.py` `draw_weights`), kept on the device as the JAX
    package's pytree of the refiner;
  * `program`: the port's refiner, built by the port's own loader
    (`models/raydrop.py` `refiner_from_tree`) from a copy of the weights,
    as `refine_color` with the depth scale: `Trainer(refine=...)`;
  * `reference`: the plain UNet's output in place of the ray drop;
  * `work`: a frame's FP32 operations and least bytes (`counts`).
"""
from __future__ import annotations

import functools
import math

import torch

from portbench.reference.unet import (LEVELS, blocks, draw_weights, padded, refine_raydrop,
                                      weight_spec)

KINDS = ("render",)
BN_OPS = 8                     # a BatchNorm per element: the mean's add; the variance's subtract,
#                                square and add; the normalization's subtract, scale, multiply, add
BN_CHANNEL_OPS = 4             # and per channel: two divides by the count, the eps add, the root
SOFTMAX_OPS = 5                # per score: the max, subtract, exp, sum and divide
UPSAMPLE_OPS = 3               # per output element of each pass (W, then H): two products, one add
POOL_OPS = 3                   # per output element: three compares
SIGMOID_OPS = 3                # exp, add, divide


def _to(tree: dict, dev) -> dict:
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


def draw(cell, seed: int, dev) -> dict:
    r = cell.config["refiner"]
    gen = torch.Generator().manual_seed(seed)
    weights = draw_weights(gen, r["in_channels"], r["channels"], r["out_channels"])
    return {"weights": _to(weights, dev), "sizes": dict(r)}


def program(drawn: dict) -> dict:
    from lidargs_torch.models.raydrop import refine_color, refiner_from_tree

    dev = drawn["weights"]["inc"]["w"].device
    model = refiner_from_tree(_to(drawn["weights"], "cpu"), dev)
    heads = drawn["sizes"]["heads"]
    if model.attn.num_head != heads:
        raise ValueError(f"the port's UNet has {model.attn.num_head} attention heads; the "
                         f"configuration asks for {heads}")
    return {"refine": functools.partial(refine_color, model,
                                        depth_scale=drawn["sizes"]["depth_scale"])}


def reference(drawn: dict, color: torch.Tensor, depth: torch.Tensor):
    """[intensity, raydrop] with the ray drop the plain UNet's output on
    [ray drop, intensity, depth / depth scale]; the depth as it is."""
    s = drawn["sizes"]
    rd = refine_raydrop(drawn["weights"], color[1], color[0], depth / s["depth_scale"],
                        s["heads"])
    return torch.stack([color[0], rd]), depth


def counts(sizes: dict, H: int, W: int) -> dict:
    """A frame's {products, elementwise, bytes} on an H x W view, padded to
    multiples of 16. Products: 2 k^2 C_in C_out a pixel of each
    convolution and 4 T^2 C for attention's two matrix products over its
    T tokens. Elementwise: one operation each add, multiply, compare,
    exp, divide or root (the constants above). Bytes: float32, the three
    input images, every weight and every activation that a layer
    produces (each convolution's, pool's, upsample's, the attention's
    product and residual) once; BatchNorm and ReLU are read into the next
    convolution and the concatenation is the two maps it joins."""
    c, heads = sizes["channels"], sizes["heads"]
    n = {"products": 0, "elementwise": H * W, "acts": 0}        # the depth's scaling

    def conv(cin, cout, k, pix, bias=False):
        n["products"] += 2 * k * k * cin * cout * pix
        n["elementwise"] += cout * pix if bias else 0
        n["acts"] += cout * pix

    def bn_relu(ch, pix):
        n["elementwise"] += (BN_OPS + 1) * ch * pix + BN_CHANNEL_OPS * ch

    def double(cin, cout, cmid, pix):
        bn_relu(cin, pix)
        conv(cin, cmid, 3, pix)
        bn_relu(cmid, pix)
        conv(cmid, cout, 3, pix)

    h, w = padded(H), padded(W)
    conv(sizes["in_channels"], c, 1, h * w, bias=True)
    for _, cin, cout, cmid in blocks(c)[:LEVELS]:
        h, w = h // 2, w // 2
        n["elementwise"] += POOL_OPS * cin * h * w
        n["acts"] += cin * h * w
        double(cin, cout, cmid, h * w)
    C, T = 8 * c, h * w                      # attention over the bottom grid
    n["elementwise"] += BN_OPS * C * T + BN_CHANNEL_OPS * C
    conv(C, 3 * C, 1, T)
    n["products"] += 4 * T * T * C
    n["elementwise"] += (1 + SOFTMAX_OPS) * heads * T * T + C * T   # scale, softmax; residual
    n["acts"] += 2 * C * T                   # the heads' product and the residual sum
    conv(C, C, 1, T)
    ch = C
    for _, cin, cout, cmid in blocks(c)[LEVELS:]:
        n["elementwise"] += UPSAMPLE_OPS * ch * (h * 2 * w + 4 * h * w)
        h, w = 2 * h, 2 * w
        n["acts"] += ch * h * w
        double(cin, cout, cmid, h * w)
        ch = cout
    bn_relu(c, h * w)
    conv(c, sizes["out_channels"], 1, h * w, bias=True)
    n["elementwise"] += SIGMOID_OPS * sizes["out_channels"] * h * w
    weights = sum(math.prod(s) for _, s in weight_spec(sizes["in_channels"], c,
                                                       sizes["out_channels"]))
    return {"products": n["products"], "elementwise": n["elementwise"],
            "bytes": 4 * (3 * H * W + weights + n["acts"])}


def work(drawn: dict, H: int, W: int):
    n = counts(drawn["sizes"], H, W)
    return n["products"] + n["elementwise"], n["bytes"]
