"""Tiny two-layer MLP heads as plain parameter dicts.

Counterpart of `lidargs_tpu/models/mlp.py`: the same `{l1: {w, b}, l2: {w,
b}}` layout, with `w` stored [d_in, d_out] so `x @ w` reads the same in both
packages. The products go to `torch.matmul`, as the JAX package leaves them
to XLA."""
from __future__ import annotations

import math

import torch


def init_linear(gen: torch.Generator, d_in: int, d_out: int, device) -> dict:
    """torch.nn.Linear's default init: U(-1/sqrt(d_in), 1/sqrt(d_in)) for
    both weight and bias. Drawn from `gen` on the CPU, then moved."""
    lim = 1.0 / math.sqrt(d_in)
    w = torch.empty((d_in, d_out), dtype=torch.float32).uniform_(-lim, lim, generator=gen)
    b = torch.empty((d_out,), dtype=torch.float32).uniform_(-lim, lim, generator=gen)
    return {"w": w.to(device), "b": b.to(device)}


def init_mlp(gen: torch.Generator, d_in: int, d_hidden: int, d_out: int, device) -> dict:
    return {"l1": init_linear(gen, d_in, d_hidden, device),
            "l2": init_linear(gen, d_hidden, d_out, device)}


def apply_mlp(params: dict, x: torch.Tensor, final_act=None) -> torch.Tensor:
    h = torch.relu(x @ params["l1"]["w"] + params["l1"]["b"])
    y = h @ params["l2"]["w"] + params["l2"]["b"]
    return final_act(y) if final_act is not None else y
