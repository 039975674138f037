"""Ray-drop refiners and their offline trainer.

Counterpart of `lidargs_tpu/models/raydrop.py`, with the same two models:

* the frequency-encoding MLP (the reference's `extre_train_raydrop.py`):
  sin/cos octaves of the ray direction (degree 4) and of (intensity, depth)
  (degree 6) into a 128x4 ReLU MLP with a sigmoid out, trained with MSE
  on dumped per-frame renders;
* LiDAR4D's attention UNet: a 1x1 in-conv to 32 channels, four (maxpool,
  double conv) levels down to 256, eight-head self-attention, four
  (bilinear x2, skip concat, double conv) levels up, and a sigmoid 1x1
  out-conv, on the [raydrop, intensity, depth] image.

Both are `nn.Module`s (`RayDropMLP`, `UNet` with `DoubleConv` and
`AttnBlock`); the plain functions beside them carry the JAX package's names.
BatchNorm always uses the batch's own statistics (no running statistics),
as JAX's `_bn`. The x2 upsampling uses half-pixel centres
(`align_corners=False`): that is what `jax.image.resize(..., "bilinear")`
computes, whatever JAX's docstring of `_upsample2` says.

Weights cross between the packages as JAX's pytrees: `refiner_tree` and
`refiner_from_tree` convert (an `nn.Linear` stores its weight [out, in],
JAX's `init_linear` [in, out]; convolutions are OIHW in both), and
`save_refiner` / `load_refiner` read and write the npz under JAX's keys
(`layers/0/w`, `dir_degree`, `inc/w`, `down1/bn1/scale`, ...). JAX's
`_double_conv` dropout option, which no caller of either package sets, is
not carried.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import resolve_device
from ..utils.serialization import save_pytree_npz, tree_paths


def _init_uniform_(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """torch's default Linear/Conv2d init, U(+-1/sqrt(fan_in)) for the
    weight and the bias (JAX's `init_linear` and `_init_conv`), drawn from
    `gen` in module order; the model must be on the CPU."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                lim = 1.0 / math.sqrt(m.weight[0].numel())
                m.weight.uniform_(-lim, lim, generator=gen)
                if m.bias is not None:
                    m.bias.uniform_(-lim, lim, generator=gen)
    return model


# ---------------------------------------------------------------------------
# frequency-encoding MLP refiner
# ---------------------------------------------------------------------------

def frequency_encode(x: torch.Tensor, degree: int) -> torch.Tensor:
    """Per input dim, `degree` octaves of (sin, cos) of 2^k * pi * x."""
    feats = []
    for k in range(degree):
        s = (2.0 ** k) * math.pi * x
        feats.append(torch.sin(s))
        feats.append(torch.cos(s))
    return torch.cat(feats, dim=-1)


class RayDropMLP(nn.Module):
    """[N,3] ray dirs + [N,1] intensity + [N,1] depth -> [N,1] ray-drop
    probability."""

    def __init__(self, dir_degree: int = 4, id_degree: int = 6, width: int = 128,
                 depth: int = 4):
        super().__init__()
        self.dir_degree, self.id_degree = dir_degree, id_degree
        dims = [3 * dir_degree * 2 + 2 * id_degree * 2] + [width] * depth + [1]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, ray_dir, intensity, depth):
        h = torch.cat([frequency_encode(ray_dir, self.dir_degree),
                       frequency_encode(torch.cat([intensity, depth], -1), self.id_degree)],
                      dim=-1)
        for lin in self.layers[:-1]:
            h = torch.relu(lin(h))
        return torch.sigmoid(self.layers[-1](h))


def init_raydrop_mlp(gen: torch.Generator, dir_degree: int = 4, id_degree: int = 6,
                     width: int = 128, depth: int = 4, device="cuda") -> RayDropMLP:
    model = _init_uniform_(RayDropMLP(dir_degree, id_degree, width, depth), gen)
    return model.to(resolve_device(device))


def apply_raydrop_mlp(model: RayDropMLP, ray_dir, intensity, depth) -> torch.Tensor:
    """[N,3] dirs + [N,1] intensity + [N,1] depth -> [N,1] raydrop prob."""
    return model(ray_dir, intensity, depth)


def refine_raydrop(model: RayDropMLP, ray_dir_hw3, intensity_hw, depth_hw) -> torch.Tensor:
    """Image-shaped wrapper: [H,W,3], [H,W], [H,W] -> [H,W]."""
    H, W = intensity_hw.shape
    p = model(ray_dir_hw3.reshape(-1, 3), intensity_hw.reshape(-1, 1), depth_hw.reshape(-1, 1))
    return p.reshape(H, W)


# ---------------------------------------------------------------------------
# LiDAR4D efficient UNet
# ---------------------------------------------------------------------------

def _init_bn(c: int) -> nn.BatchNorm2d:
    """Scale 1, bias 0, eps 1e-5; normalizes by the mean and biased variance
    over (N, H, W) of the input it is given, in training and eval mode
    alike (no running statistics)."""
    return nn.BatchNorm2d(c, eps=1e-5, track_running_stats=False)


def _init_conv(c_in: int, c_out: int, k: int, bias: bool = True) -> nn.Conv2d:
    """Stride 1, 'SAME' padding."""
    return nn.Conv2d(c_in, c_out, k, padding=k // 2, bias=bias)


class DoubleConv(nn.Module):
    """BN-ReLU-conv3x3, twice (pre-activation)."""

    def __init__(self, c_in: int, c_out: int, c_mid: Optional[int] = None):
        super().__init__()
        c_mid = c_mid or c_out
        self.bn1 = _init_bn(c_in)
        self.conv1 = _init_conv(c_in, c_mid, 3, bias=False)
        self.bn2 = _init_bn(c_mid)
        self.conv2 = _init_conv(c_mid, c_out, 3, bias=False)

    def forward(self, x):
        h = self.conv1(torch.relu(self.bn1(x)))
        return self.conv2(torch.relu(self.bn2(h)))


def _maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2, stride 2; an odd last row or column is dropped."""
    return F.max_pool2d(x, 2)


def _double(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`x` resized to twice its length along `dim` by the half-pixel
    bilinear rule: out[2i] = 0.75 x[i] + 0.25 x[i-1] and out[2i+1] =
    0.75 x[i] + 0.25 x[i+1], and the first and last outputs are x[0] and
    x[n-1] themselves (`jax.image.resize` drops the missing neighbour's
    weight and renormalizes). Slices, products, sums and `stack`: its
    autograd backward gathers in a fixed order, with no atomics."""
    n = x.shape[dim]
    lo, hi = x.narrow(dim, 0, n - 1), x.narrow(dim, 1, n - 1)
    even = torch.cat([x.narrow(dim, 0, 1), 0.75 * hi + 0.25 * lo], dim)
    odd = torch.cat([0.75 * lo + 0.25 * hi, x.narrow(dim, n - 1, 1)], dim)
    return torch.stack([even, odd], dim + 1).flatten(dim, dim + 1)


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 with half-pixel centres (align_corners=False), as
    `jax.image.resize(..., "bilinear")`: along W, then along H (the order
    nearer XLA's rounding). Written in torch ops because the CUDA backward
    of `F.interpolate`'s bilinear mode accumulates with atomics, in an
    order that may change from run to run."""
    return _double(_double(x, 3), 2)


class AttnBlock(nn.Module):
    """Multi-head self-attention over the HxW grid, added to its input:
    matmul, softmax, matmul, as JAX's `_attn` writes it (its head-mixing
    reshape of the result included)."""

    def __init__(self, c: int, num_head: int = 8):
        super().__init__()
        self.num_head = num_head
        self.norm = _init_bn(c)
        self.qkv = _init_conv(c, 3 * c, 1, bias=False)
        self.proj = _init_conv(c, c, 1, bias=False)

    def forward(self, x):
        N, C, H, W = x.shape
        nh, d = self.num_head, C // self.num_head
        q, k, v = self.qkv(self.norm(x)).chunk(3, dim=1)
        q = q.reshape(N, nh, d, H * W).transpose(2, 3)
        k = k.reshape(N, nh, d, H * W)
        v = v.reshape(N, nh, d, H * W).transpose(2, 3)
        w = torch.softmax(torch.matmul(q, k) * (d ** -0.5), dim=-1)
        h = torch.matmul(w, v).reshape(N, H, W, C).permute(0, 3, 1, 2)
        return x + self.proj(h)


def _pad_to(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Zero-pad x1 spatially to x2's shape, split evenly (the extra row or
    column at the bottom / right)."""
    dy = x2.shape[2] - x1.shape[2]
    dx = x2.shape[3] - x1.shape[3]
    return F.pad(x1, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))


class UNet(nn.Module):
    """[N, in_ch, H, W] -> [N, out_ch, H, W] refined ray-drop probability.
    H and W must be multiples of 16 (four maxpool levels): pad first
    (`_pad16`)."""

    def __init__(self, in_channels: int = 3, channels: int = 32, out_channels: int = 1):
        super().__init__()
        c = channels
        self.inc = _init_conv(in_channels, c, 1)
        self.down1 = DoubleConv(c, 2 * c)
        self.down2 = DoubleConv(2 * c, 4 * c)
        self.down3 = DoubleConv(4 * c, 8 * c)
        self.down4 = DoubleConv(8 * c, 8 * c)
        self.attn = AttnBlock(8 * c)
        self.up1 = DoubleConv(16 * c, 4 * c, 16 * c)
        self.up2 = DoubleConv(8 * c, 2 * c, 8 * c)
        self.up3 = DoubleConv(4 * c, c, 4 * c)
        self.up4 = DoubleConv(2 * c, c, 2 * c)
        self.out_bn = _init_bn(c)
        self.outc = _init_conv(c, out_channels, 1)

    def forward(self, x):
        x0 = self.inc(x)
        x1 = self.down1(_maxpool2(x0))
        x2 = self.down2(_maxpool2(x1))
        x3 = self.down3(_maxpool2(x2))
        x4 = self.attn(self.down4(_maxpool2(x3)))

        def up(block, a, b):
            return block(torch.cat([b, _pad_to(_upsample2(a), b)], dim=1))

        h = up(self.up1, x4, x3)
        h = up(self.up2, h, x2)
        h = up(self.up3, h, x1)
        h = up(self.up4, h, x0)
        return torch.sigmoid(self.outc(torch.relu(self.out_bn(h))))


def init_unet(gen: torch.Generator, in_channels: int = 3, channels: int = 32,
              out_channels: int = 1, device="cuda") -> UNet:
    model = _init_uniform_(UNet(in_channels, channels, out_channels), gen)
    return model.to(resolve_device(device))


def apply_unet(model: UNet, x: torch.Tensor) -> torch.Tensor:
    return model(x)


def _pad16(x_chw: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Zero-pad [C, H, W] at the bottom and right to multiples of 16;
    returns (padded, (H, W)) for cropping back."""
    _, H, W = x_chw.shape
    return F.pad(x_chw, (0, -W % 16, 0, -H % 16)), (H, W)


def refine_raydrop_unet(model: UNet, raydrop_hw, intensity_hw, depth_hw) -> torch.Tensor:
    """[raydrop, intensity, depth] images -> refined ray-drop probability
    [H, W]."""
    x, (H, W) = _pad16(torch.stack([raydrop_hw, intensity_hw, depth_hw], 0))
    return model(x[None])[0, 0, :H, :W]


Refiner = Union[RayDropMLP, UNet]


def refine_color(model: Refiner, color: torch.Tensor, depth: torch.Tensor,
                 depth_scale: float, ray_dirs_hw3: Optional[torch.Tensor] = None):
    """A render's [intensity, raydrop] with the ray-drop row replaced by the
    refiner's, from depth / `depth_scale` (the MLP also takes each pixel's
    ray direction)."""
    if isinstance(model, UNet):
        rd = refine_raydrop_unet(model, color[1], color[0], depth / depth_scale)
    else:
        rd = refine_raydrop(model, ray_dirs_hw3, color[0], depth / depth_scale)
    return torch.stack([color[0], rd], 0)


# ---------------------------------------------------------------------------
# offline training: Adam, MSE, lr0 * decay^(step / n_iters)
# ---------------------------------------------------------------------------

def refiner_optimizer(model: nn.Module, lr: float = 5e-4, decay_rate: float = 0.1,
                      n_iters: int = 10_000):
    """optax.adam(lr0 * decay^(count / n_iters)) as torch.optim: eps 1e-8
    outside the root, the schedule read at the update count from 0."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda step: decay_rate ** (step / n_iters))
    return opt, sched


def mlp_loss(model: RayDropMLP, dirs, intensity, depth, gt) -> torch.Tensor:
    """MSE of the predicted ray drop over one frame's rays."""
    p = model(dirs, intensity[:, None], depth[:, None])
    return torch.mean((p[:, 0] - gt) ** 2)


def unet_loss(model: UNet, x, gt) -> torch.Tensor:
    """MSE over the real pixels of one padded [3, Hp, Wp] frame."""
    H, W = gt.shape
    return torch.mean((model(x[None])[0, 0, :H, :W] - gt) ** 2)


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN held to its deterministic algorithms, without benchmarking,
    while the block runs (the previous flags after): the UNet's convolution
    backwards then give the same bits from the same inputs. The flags are
    process-wide, so they also reach the autograd engine's device thread."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def refine_step(model: nn.Module, opt, sched, loss_fn: Callable, *inputs) -> torch.Tensor:
    """One Adam step on `loss_fn(model, *inputs)`; the loss stays on the
    device. A UNet's step runs under `deterministic_convs`, so that its
    training is reproducible bit for bit on the card."""
    with deterministic_convs() if isinstance(model, UNet) else contextlib.nullcontext():
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, *inputs)
        loss.backward()
        opt.step()
        sched.step()
    return loss.detach()


def _fit(model, loss_fn, frames: List[tuple], epochs, lr, decay_rate, n_iters, log_every,
         tag) -> List[float]:
    """One step per frame per epoch; the history is the last frame's loss
    of each epoch."""
    opt, sched = refiner_optimizer(model, lr, decay_rate, n_iters)
    history = []
    for epoch in range(epochs):
        for inputs in frames:
            loss = refine_step(model, opt, sched, loss_fn, *inputs)
        history.append(float(loss))
        if log_every and (epoch + 1) % log_every == 0:
            print(f"[{tag}] epoch {epoch + 1}: loss {history[-1]:.6f}")
    return history


def _on(model: nn.Module, *arrays) -> List[torch.Tensor]:
    """float32 tensors on the model's device, each copied there once."""
    dev = next(model.parameters()).device
    return [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in arrays]


def train_raydrop_refiner(model: RayDropMLP, ray_dirs, intensity, depth, gt_raydrop,
                          epochs: int = 100, lr: float = 5e-4, decay_rate: float = 0.1,
                          n_iters: int = 10_000, log_every: int = 0):
    """Train `model` in place on [H*W, 3] shared ray dirs and [N, H*W]
    intensity, depth (pre-scaled) and GT ray drop per frame. Returns
    (model, history)."""
    dirs, inten, dep, gt = _on(model, ray_dirs, intensity, depth, gt_raydrop)
    frames = [(dirs, inten[i], dep[i], gt[i]) for i in range(inten.shape[0])]
    return model, _fit(model, mlp_loss, frames, epochs, lr, decay_rate, n_iters, log_every,
                       "raydrop")


def train_unet_refiner(model: UNet, raydrop, intensity, depth, gt_raydrop,
                       epochs: int = 100, lr: float = 5e-4, decay_rate: float = 0.1,
                       n_iters: int = 10_000, log_every: int = 0):
    """Train `model` in place on [N, H, W] rendered ray drop, intensity,
    depth (pre-scaled) and GT ray drop: the full image, padded to multiples
    of 16, the loss on the real pixels. Returns (model, history)."""
    rd, inten, dep, gt = _on(model, raydrop, intensity, depth, gt_raydrop)
    frames = [(_pad16(torch.stack([rd[i], inten[i], dep[i]]))[0], gt[i])
              for i in range(rd.shape[0])]
    return model, _fit(model, unet_loss, frames, epochs, lr, decay_rate, n_iters, log_every,
                       "unet")


# ---------------------------------------------------------------------------
# weights in JAX's pytree layout and npz keys
# ---------------------------------------------------------------------------

_LEAF_NAMES = {nn.Linear: ("w", "b"), nn.Conv2d: ("w", "b"), nn.BatchNorm2d: ("scale", "bias")}


def _jax_params(model: Refiner) -> Iterator[Tuple[str, nn.Parameter, bool]]:
    """(JAX path key, parameter, stored transposed in JAX) of each parameter."""
    for name, m in model.named_modules():
        names = _LEAF_NAMES.get(type(m))
        if names is None:
            continue
        prefix = name.replace(".", "/")
        for leaf, p in zip(names, (m.weight, m.bias)):
            if p is not None:
                yield f"{prefix}/{leaf}", p, isinstance(m, nn.Linear) and leaf == "w"


def _flat(model: Refiner) -> Dict[str, np.ndarray]:
    out = {k: (p.detach().T if t else p.detach()).cpu().numpy().copy()
           for k, p, t in _jax_params(model)}
    if isinstance(model, RayDropMLP):
        out["dir_degree"], out["id_degree"] = model.dir_degree, model.id_degree
    return out


def _unflatten(flat: dict):
    """Nested dicts from `/`-joined keys; a level keyed 0..n-1 is a list."""
    tree: dict = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def refiner_tree(model: Refiner) -> dict:
    """The model's weights as the JAX package's pytree (numpy arrays): what
    `init_raydrop_mlp` / `init_unet` return there."""
    return _unflatten(_flat(model))


def _from_flat(flat: dict, device) -> Refiner:
    if any(k.startswith("inc") for k in flat):
        w = np.asarray(flat["inc/w"])
        model = UNet(w.shape[1], w.shape[0], np.asarray(flat["outc/w"]).shape[0])
    else:
        n = sum(k.startswith("layers/") and k.endswith("/w") for k in flat)
        model = RayDropMLP(int(flat["dir_degree"]), int(flat["id_degree"]),
                           np.asarray(flat["layers/0/w"]).shape[1], n - 1)
    with torch.no_grad():
        for key, p, transposed in _jax_params(model):
            if key not in flat:
                raise KeyError(f"refiner missing leaf {key}")
            a = torch.from_numpy(np.array(flat[key], np.float32))
            a = a.T if transposed else a
            if a.shape != p.shape:
                raise ValueError(f"refiner leaf {key}: shape {tuple(a.shape)}, "
                                 f"expected {tuple(p.shape)}")
            p.copy_(a)
    return model.to(resolve_device(device))


def refiner_from_tree(tree: dict, device="cuda") -> Refiner:
    """A JAX refiner pytree (`init_raydrop_mlp` / `init_unet` layout, numpy
    or JAX arrays) as the port's module; the architecture and its sizes
    are read from the tree."""
    return _from_flat(dict(tree_paths(tree)), device)


def save_refiner(path: str, model: Refiner) -> None:
    """The npz that the JAX package's `save_pytree_npz` writes for the
    same weights."""
    save_pytree_npz(path, refiner_tree(model))


def load_refiner(path: str, device="cuda") -> Refiner:
    """A refiner npz of either package; the UNet is told by its `inc` keys."""
    with np.load(path) as z:
        return _from_flat({k: z[k] for k in z.files}, device)
