"""The UNet refiner's reproducibility pieces (`lidargs_torch/models/raydrop.py`,
`lidargs_torch/utils/unet_repro.py`) on the CPU.

* `_upsample2`, now blends of torch ops whose backward has a fixed order,
  against JAX's `_upsample2` (`jax.image.resize`, bilinear) and its
  `jax.vjp`, on odd and even sizes. Tolerance: 1e-6 of the largest input
  (forward) or cotangent (backward) magnitude: both are sums of two or
  four weighted terms with weights 0.75 / 0.25, rounded in another order
  than XLA's single contraction (measured: 3.6e-7 forward, 9.5e-7
  backward at unit scale); the corners, which both packages copy, are
  equal bit for bit. No bilinear-upsample node (whose CUDA backward
  accumulates with atomics) is left in the graph.
* The float64 pass that finds the leaves whose exact gradient is 0
  (`zero_exact_leaves`): at the refiner's channels (32) it finds `inc.bias`
  alone, and every other leaf's gradient is at least 1e-6 of the whole's
  (measured: the smallest, `attn.norm.weight`, ~1e-4).
* The bound `chip_smoke.py` holds such a leaf to on the card against the
  CPU, `zero_eps` float32 epsilons of its rounding scale (the norm over
  channels of the per-channel L1 norm of the gradient at its module's
  output): the CPU's float32 gradient lies within half of it (one side's
  share) of the float64 one over 20 seeds at a reduced frame (32 x 128).
  The bound is set for the street's 64 x 2656 frames, where the CPU's
  float32 lay 2.4-7.5 epsilons from float64 on the H100's host
  (`lidargs_torch/utils/unet_repro.py`); at this reduced frame the test
  leaves a wide margin.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lidargs_tpu.models import raydrop as jr
from lidargs_torch.models import raydrop as tr
from lidargs_torch.utils import unet_repro
from lidargs_torch.utils.testing import one_torch_thread


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


EPS32 = float(np.finfo(np.float32).eps)


def _graph_names(fn) -> set:
    """The names of every autograd node reachable from `fn`."""
    seen, todo = set(), [fn]
    while todo:
        f = todo.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        todo.extend(nxt for nxt, _ in f.next_functions)
    return {type(f).__name__ for f in seen}


@pytest.mark.parametrize("shape", [(1, 4, 4, 166), (2, 3, 5, 7), (1, 2, 1, 1), (1, 3, 1, 6),
                                   (1, 8, 6, 9)])
def test_upsample2_matches_jax_forward_and_vjp(shape):
    rng = np.random.default_rng(sum(shape))
    y = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape[:2] + (2 * shape[2], 2 * shape[3])).astype(np.float32)
    want, vjp = jax.vjp(jr._upsample2, jnp.asarray(y))
    want, (dwant,) = np.asarray(want), (np.asarray(d) for d in vjp(jnp.asarray(g)))
    x = torch.from_numpy(y).requires_grad_(True)
    out = tr._upsample2(x)
    out.backward(torch.from_numpy(g))
    got = out.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(y).max())
    np.testing.assert_allclose(x.grad.numpy(), dwant, rtol=0, atol=1e-6 * np.abs(g).max())
    for i in (0, -1):
        for j in (0, -1):
            assert got[..., i, j].tobytes() == want[..., i, j].tobytes() == y[..., i, j].tobytes()
    names = _graph_names(out.grad_fn)
    assert not any("Upsample" in n for n in names), names


def _unet_inputs(seed: int, h: int, w: int):
    """torch seed `seed`'s UNet (channels 32) and a padded [3, Hp, Wp] frame
    with its [h, w] GT, from numpy seed `seed`."""
    rng = np.random.default_rng(seed)
    model = tr.init_unet(torch.Generator().manual_seed(seed), device="cpu")
    x, _ = tr._pad16(torch.from_numpy(rng.uniform(size=(3, h, w)).astype(np.float32)))
    gt = torch.from_numpy((rng.uniform(size=(h, w)) > 0.5).astype(np.float32))
    return model, x, gt


@pytest.mark.parametrize("seed", [0, 1])
def test_float64_pass_finds_the_zero_exact_leaves(seed):
    model, x, gt = _unet_inputs(seed, 30, 120)          # padded to 32 x 128, cropped back
    zero = unet_repro.zero_exact_leaves(model, x, gt)
    assert set(zero) == {"inc.bias"} and zero["inc.bias"] > 0
    _, g64, l1 = unet_repro.unet_grads(copy.deepcopy(model).double(), x, gt)
    total = np.sqrt(sum(float((v ** 2).sum()) for v in g64.values()))
    for k, v in g64.items():
        if k != "inc.bias":
            assert np.linalg.norm(v) >= 1e-6 * total, k
    assert zero["inc.bias"] == pytest.approx(float(np.linalg.norm(l1["inc"])))


def test_zero_exact_leaf_that_is_no_bias_raises():
    """A zero-exact leaf needs a rounding scale; only a bias has one."""
    g = {"a.weight": np.zeros(3), "a.bias": np.ones(3)}
    with pytest.raises(ValueError, match="no rounding scale"):
        unet_repro.zero_leaves_of(g, {"a": np.ones(3)})
    assert unet_repro.zero_leaves_of({"a.bias": np.zeros(3), "b.weight": np.ones(3)},
                                     {"a": np.full(3, 2.0)}) == {"a.bias": np.sqrt(12.0)}


@pytest.mark.parametrize("seed", range(20))
def test_zero_leaf_bound_holds_for_cpu_float32(seed):
    model, x, gt = _unet_inputs(100 + seed, 32, 128)
    zero = unet_repro.zero_exact_leaves(model, x, gt)
    _, g32, _ = unet_repro.unet_grads(model, x, gt)
    _, g64, _ = unet_repro.unet_grads(copy.deepcopy(model).double(), x, gt)
    for k, scale in zero.items():
        err = float(np.linalg.norm(g32[k] - g64[k]))
        assert err <= 0.5 * chip_smoke.UNET_CARD_TOL["zero_eps"] * EPS32 * scale, (k, err, scale)
        assert err > 0                                   # float32 rounding is there to bound
