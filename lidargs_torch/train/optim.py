"""Per-group Adam with schedule-driven learning rates.

Counterpart of `lidargs_tpu/train/optim.py`. Hand-rolled rather than
`torch.optim`, so that the moment buffers mirror the parameter dict one to
one: densification edits the moments row by row with the same writes as
the parameters (`models/densify.py`). The math is torch.optim.Adam's (eps
added outside the sqrt, bias correction on both moments). Groups with a
zero learning rate (the frozen `rotation` and `opacity`) still update their
moments, as in the JAX package.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

from ..config import OptConfig
from .schedule import const_lr, expon_lr

Schedule = Callable[[torch.Tensor], torch.Tensor]


class AdamState(NamedTuple):
    mu: dict
    nu: dict
    count: torch.Tensor          # [] int32


def tree_map(fn, *trees):
    """`fn` over the leaves of nested dicts with the same keys."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, in key order."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves) -> dict:
    """Nested dicts shaped like `like` holding `leaves` (from tree_leaves)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def lr_schedules(ocfg: OptConfig) -> Dict[str, Schedule]:
    """Top-level param key -> lr(step). The frozen groups get lr 0."""
    zero = const_lr(0.0)
    return {
        "anchor": expon_lr(ocfg.anchor_lr),
        "offset": expon_lr(ocfg.offset_lr),
        "feat": const_lr(ocfg.feature_lr),
        "scaling": const_lr(ocfg.scaling_lr),
        "rotation": zero,
        "opacity": zero,
        "mlp_opacity": expon_lr(ocfg.mlp_opacity_lr),
        "mlp_cov": expon_lr(ocfg.mlp_cov_lr),
        # the raydrop head follows the color schedule, as in the reference
        "mlp_color": expon_lr(ocfg.mlp_color_lr),
        "mlp_raydrop": expon_lr(ocfg.mlp_color_lr),
        "mlp_featbank": expon_lr(ocfg.mlp_featurebank_lr),
        "appearance": expon_lr(ocfg.appearance_lr),
        "appearance_rd": expon_lr(ocfg.appearance_lr),
    }


def init_adam(params: dict) -> AdamState:
    dev = tree_leaves(params)[0].device
    return AdamState(mu=tree_map(torch.zeros_like, params),
                     nu=tree_map(torch.zeros_like, params),
                     count=torch.zeros((), dtype=torch.int32, device=dev))


@torch.no_grad()
def adam_update(
    params: dict,
    grads: dict,
    state: AdamState,
    schedules: Dict[str, Schedule],
    step,
    ocfg: OptConfig,
    b1: float = 0.9,
    b2: float = 0.999,
):
    """One Adam step over every group: (new params, new AdamState). The
    inputs are left as they are."""
    count = state.count + 1
    bc1 = 1.0 - b1 ** count.to(torch.float32)
    bc2 = 1.0 - b2 ** count.to(torch.float32)
    step = torch.as_tensor(step, device=count.device)

    new_params, new_mu, new_nu = {}, {}, {}
    for key, p in params.items():
        lr = schedules[key](step)

        def upd(p_, g_, mu_, nu_):
            mu2 = b1 * mu_ + (1 - b1) * g_
            nu2 = b2 * nu_ + (1 - b2) * g_ * g_
            step_ = lr * (mu2 / bc1) / (torch.sqrt(nu2 / bc2) + ocfg.adam_eps)
            return p_ - step_, mu2, nu2

        out = tree_map(upd, p, grads[key], state.mu[key], state.nu[key])
        pick = lambda i: tree_map(lambda t: t[i], out) if isinstance(out, dict) else out[i]
        new_params[key], new_mu[key], new_nu[key] = pick(0), pick(1), pick(2)

    return new_params, AdamState(mu=new_mu, nu=new_nu, count=count)
