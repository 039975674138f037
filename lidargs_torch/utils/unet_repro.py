"""Whether the UNet refiner trains bit-reproducibly on a card, and what breaks it.

    python -m lidargs_torch.utils.unet_repro [--steps N] [--frames F]

Trains the refiner's UNet (channels 32, torch seed 0, on random frames of
the street's 64 x 2650 range view padded to 64 x 2656, made from a numpy
seed) twice from equal inputs with `raydrop.refine_step`, in four variants:

  * `interpolate`: the x2 upsampling by `F.interpolate(..., "bilinear",
    align_corners=False)` and cuDNN's default algorithm choice;
  * `interpolate+cudnn`: the same under `raydrop.deterministic_convs`;
  * `blend`: the package's `_upsample2` (torch-op blends), cuDNN's default;
  * `blend+cudnn`: the package as it is.

For each it compares the two runs after every step: the loss, every
parameter and every gradient bit for bit, and, through hooks on every
Conv2d and BatchNorm2d, each module's output (forward order) and the
gradients at its output and input (backward order). For the first step
that differs it lists, in backward order, the modules whose gradients
differ: the first one whose output gradient differs follows the op that
broke the bits (a functional op between two modules, such as the
upsampling, or a module whose input gradient differs from equal output
gradients). Then it runs one step under
`torch.use_deterministic_algorithms(True, warn_only=True)` and keeps the
warnings (each names an op without a deterministic CUDA implementation),
one step with `warn_only=False` (the error, or none), and times a step
(CUDA events, median of 10 after 3 warm-ups). Last, for a few UNets at
init, it measures the rounding of each leaf whose exact gradient is 0
(`zero_exact_leaves`) on the card and on the CPU against float64
(`zero_leaf_rounding`). Prints one JSON line with the card's name and
power limit.

`unet_grads` and `zero_exact_leaves` also serve `chip_smoke.py`'s check of
the UNet on the card against the CPU.

cuBLAS is deterministic only with a fixed workspace, so the script sets
`CUBLAS_WORKSPACE_CONFIG=:4096:8` before CUDA starts, as
`torch.use_deterministic_algorithms` requires.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import warnings

import numpy as np

H, W = 64, 2650                  # the street's range view (chip_smoke.py's CLI_SCENE)
VARIANTS = ("interpolate", "interpolate+cudnn", "blend", "blend+cudnn")
ZERO_LEAF_REL = 1e-9             # a leaf's float64 gradient below this share of the whole's: 0


def unet_grads(model, x, gt) -> tuple:
    """The UNet's output, parameter gradients and, for each Conv2d and
    BatchNorm2d, the per-channel L1 norm of the gradient at its output
    (numpy, float64), for the MSE over the real pixels of one padded frame
    `x` ([3, Hp, Wp]) against `gt` ([H, W]), on the model's device and in
    its dtype."""
    import torch
    import torch.nn as nn

    p = next(model.parameters())
    h, w = gt.shape
    l1, handles = {}, []

    def tap(name):
        def fwd(mod, args, out):
            def keep(g):
                l1[name] = g.detach().abs().sum((0, 2, 3)).double().cpu().numpy()
            out.register_hook(keep)
        return fwd

    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.BatchNorm2d)):
            handles.append(m.register_forward_hook(tap(name)))
    try:
        model.zero_grad(set_to_none=True)
        out = model(x.to(p.device, p.dtype)[None])
        torch.mean((out[0, 0, :h, :w] - gt.to(p.device, p.dtype)) ** 2).backward()
    finally:
        for hd in handles:
            hd.remove()
    grads = {k: q.grad.detach().double().cpu().numpy() for k, q in model.named_parameters()}
    return out.detach().double().cpu().numpy(), grads, l1


def zero_exact_leaves(model, x, gt) -> dict:
    """The parameter leaves whose exact gradient is 0, found by a float64
    pass on the CPU: a gradient below ZERO_LEAF_REL of the whole's norm.
    Maps each to the rounding scale of its float32 gradient: a bias's
    gradient sums the gradient at its module's output over the pixels, so
    its scale is the norm over channels of that gradient's per-channel L1
    norm (in float64). Raises on a zero-exact leaf that is no bias.

    In the refiner's UNet this is `inc.bias`: the 1x1 in-conv's output
    reaches the loss only through training-mode BatchNorms (`down1.bn1`
    after a max-pool, which commutes with a per-channel shift, and
    `up4.bn1` through the skip), which take any per-channel shift out."""
    import copy

    return zero_leaves_of(*unet_grads(copy.deepcopy(model).cpu().double(), x, gt)[1:])


def zero_leaves_of(g: dict, l1: dict) -> dict:
    """`zero_exact_leaves` from a float64 pass's gradients and output L1
    norms (`unet_grads`)."""
    total = np.sqrt(sum(float((v ** 2).sum()) for v in g.values()))
    out = {}
    for k, v in g.items():
        if not float(np.linalg.norm(v)) < ZERO_LEAF_REL * total:
            continue
        module, leaf = k.rsplit(".", 1)
        if leaf != "bias":
            raise ValueError(f"UNet leaf {k}: exact gradient 0 and no rounding scale for a {leaf}")
        out[k] = float(np.linalg.norm(l1[module]))
    return out


def _frames(n: int, seed: int, dev):
    """`n` (padded [3, Hp, Wp] input, [H, W] GT) pairs: ray drop, intensity
    and depth / 80 uniform in [0, 1), GT ray drop a coin."""
    import torch

    from ..models.raydrop import _pad16

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = torch.from_numpy(rng.uniform(size=(3, H, W)).astype(np.float32)).to(dev)
        gt = torch.from_numpy((rng.uniform(size=(H, W)) > 0.5).astype(np.float32)).to(dev)
        out.append((_pad16(x)[0], gt))
    return out


@contextlib.contextmanager
def _variant(name: str):
    """The package's raydrop module with the variant's upsampling and cuDNN
    scope swapped in while the block runs."""
    import torch.nn.functional as F

    from ..models import raydrop

    saved = raydrop._upsample2, raydrop.deterministic_convs
    if name.startswith("interpolate"):
        raydrop._upsample2 = lambda x: F.interpolate(x, scale_factor=2, mode="bilinear",
                                                     align_corners=False)
    if not name.endswith("+cudnn"):
        raydrop.deterministic_convs = contextlib.nullcontext
    try:
        yield
    finally:
        raydrop._upsample2, raydrop.deterministic_convs = saved


def _hooked(model, fwd: dict, bwd: list):
    """Hooks on every Conv2d and BatchNorm2d of `model`: its output into
    `fwd` (forward order), (name, output gradient, input gradient) onto
    `bwd` (backward order). Returns the handles."""
    import torch.nn as nn

    handles = []
    for name, m in model.named_modules():
        if not isinstance(m, (nn.Conv2d, nn.BatchNorm2d)):
            continue
        handles.append(m.register_forward_hook(
            lambda mod, args, out, name=name: fwd.__setitem__(name, out.detach().clone())))
        handles.append(m.register_full_backward_hook(
            lambda mod, g_in, g_out, name=name: bwd.append(
                (name, g_out[0].detach().clone(),
                 None if g_in[0] is None else g_in[0].detach().clone()))))
    return handles


def _train(steps: int, frames: list, dev, reference: list | None = None) -> list:
    """`steps` refine steps from torch seed 0's UNet, one frame a step in
    turn. Without `reference` returns each step's record (loss, parameters,
    gradients, module outputs and gradients); with it compares each step
    to the reference's at once (keeping only the verdicts)."""
    import torch

    from ..models import raydrop

    model = raydrop.init_unet(torch.Generator().manual_seed(0), device=dev)
    opt, sched = raydrop.refiner_optimizer(model)
    out = []
    eq = lambda a, b: a is None and b is None or (
        a is not None and b is not None and bool(torch.equal(a, b)))
    for s in range(steps):
        fwd, bwd = {}, []
        handles = _hooked(model, fwd, bwd)
        try:
            loss = raydrop.refine_step(model, opt, sched, raydrop.unet_loss, *frames[s % len(frames)])
        finally:
            for h in handles:
                h.remove()
        rec = {"loss": loss, "fwd": fwd, "bwd": bwd,
               "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()},
               "params": {n: p.detach().clone() for n, p in model.named_parameters()}}
        if reference is None:
            out.append(rec)
            continue
        ref = reference[s]
        out.append({
            "step": s,
            "loss_equal": eq(rec["loss"], ref["loss"]),
            "params_differ": [n for n, p in rec["params"].items() if not eq(p, ref["params"][n])],
            "grads_differ": [n for n, g in rec["grads"].items() if not eq(g, ref["grads"][n])],
            "first_forward_output_differ": next(
                (n for n, o in rec["fwd"].items() if not eq(o, ref["fwd"][n])), None),
            # backward order: (module, its output gradient equal, its input gradient equal)
            "backward": [(n, eq(go, rgo), eq(gi, rgi))
                         for (n, go, gi), (_, rgo, rgi) in zip(rec["bwd"], ref["bwd"])],
        })
    return out


def _deterministic_probe(frames: list, dev) -> dict:
    """One refine step under `torch.use_deterministic_algorithms(True,
    warn_only=True)` (its warnings) and one with `warn_only=False` (the
    error it raises, or None)."""
    import torch

    from ..models import raydrop

    model = raydrop.init_unet(torch.Generator().manual_seed(0), device=dev)
    opt, sched = raydrop.refiner_optimizer(model)
    step = lambda: raydrop.refine_step(model, opt, sched, raydrop.unet_loss, *frames[0])
    res = {}
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step()
            torch.cuda.synchronize()
        res["warnings"] = sorted({str(w.message)[:200] for w in caught})
        torch.use_deterministic_algorithms(True)
        try:
            step()
            torch.cuda.synchronize()
            res["raises"] = None
        except RuntimeError as e:
            res["raises"] = str(e)[:300]
    finally:
        torch.use_deterministic_algorithms(False)
    return res


def _step_ms(frames: list, dev, iters: int = 10, warmup: int = 3) -> float:
    import torch

    from ..models import raydrop

    model = raydrop.init_unet(torch.Generator().manual_seed(0), device=dev)
    opt, sched = raydrop.refiner_optimizer(model)
    step = lambda: raydrop.refine_step(model, opt, sched, raydrop.unet_loss, *frames[0])
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    ev[0].record()
    for i in range(iters):
        step()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return float(np.median([ev[i].elapsed_time(ev[i + 1]) for i in range(iters)]))


def zero_leaf_rounding(dev, seeds: int) -> list:
    """For `seeds` UNets (torch seeds 0..) at init on random frames (numpy
    seeds 100..): each zero-exact leaf's gradient on the card (float32,
    deterministic cuDNN) and on the CPU (float32) against the CPU's float64
    one, and the two float32 ones against each other, each in float32
    epsilons of the leaf's rounding scale (`zero_exact_leaves`); and the
    card's distance from the CPU's as a share of the whole gradient's norm."""
    import copy

    import torch

    from ..models import raydrop

    eps = float(np.finfo(np.float32).eps)
    out = []
    for seed in range(seeds):
        model = raydrop.init_unet(torch.Generator().manual_seed(seed), device=dev)
        x, gt = _frames(1, 100 + seed, dev)[0]
        with raydrop.deterministic_convs():
            g_card = unet_grads(model, x, gt)[1]
        g_cpu = unet_grads(copy.deepcopy(model).cpu(), x, gt)[1]
        g64, l1 = unet_grads(copy.deepcopy(model).cpu().double(), x, gt)[1:]
        total = np.sqrt(sum(float((v ** 2).sum()) for v in g64.values()))
        d = lambda a, b, k: float(np.linalg.norm(a[k] - b[k]))
        for k, scale in zero_leaves_of(g64, l1).items():
            out.append({"seed": seed, "leaf": k, "scale": scale,
                        "card_vs_f64_eps": d(g_card, g64, k) / (eps * scale),
                        "cpu_vs_f64_eps": d(g_cpu, g64, k) / (eps * scale),
                        "card_vs_cpu_eps": d(g_card, g_cpu, k) / (eps * scale),
                        "card_vs_cpu_of_whole": d(g_card, g_cpu, k) / total})
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser("lidargs_torch UNet reproducibility")
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--frames", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rounding_seeds", type=int, default=3)
    args = p.parse_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    # the hook on `inc`, whose input needs no gradient, fires on its output's
    warnings.filterwarnings("ignore", message="Full backward hook is firing")

    if not torch.cuda.is_available():
        sys.exit("unet_repro: needs a CUDA device")
    dev = torch.device("cuda", 0)
    frames = _frames(args.frames, args.seed, dev)
    out = {}
    for name in VARIANTS:
        with _variant(name):
            ref = _train(args.steps, frames, dev)
            cmp = _train(args.steps, frames, dev, reference=ref)
            del ref
            differ = [c for c in cmp if not c["loss_equal"] or c["params_differ"]
                      or c["grads_differ"]]
            first = differ[0] if differ else None
            if first is not None:
                first["backward_differ"] = [b for b in first.pop("backward")
                                            if not (b[1] and b[2])]
            out[name] = {
                "steps_equal": [c["loss_equal"] and not c["params_differ"]
                                and not c["grads_differ"] for c in cmp],
                "first_differing_step": first,
                "deterministic_algorithms": _deterministic_probe(frames, dev),
                "step_ms_median": _step_ms(frames, dev),
            }
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    rounding = zero_leaf_rounding(dev, args.rounding_seeds)
    print(json.dumps({"card": card, "torch": torch.__version__, "steps": args.steps,
                      "frames": args.frames, "variants": out, "zero_leaf_rounding": rounding}))


if __name__ == "__main__":
    main()
