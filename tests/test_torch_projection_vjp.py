"""The port's hand projection VJP (`preprocess_gaussians_hv`) against torch
autograd of the plain projection and against the JAX package's hand VJP.

The scene of `tests/test_projection_vjp.py` exercises every cull branch:
masked rows, a degenerate vertical ray, a point on the sensor, far and near
rows. Tolerances: in float64 the hand VJP must equal autograd to 1e-10
(the math is the same, only the order of sums differs); in float32 against
the JAX package 2e-4 relative and absolute, as the JAX package holds its own
hand VJP to its autodiff in float32 (f32 reassociation, and atan2/exp ulps
between XLA and PyTorch). `beams` gets a zero gradient by design.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidargs_tpu.ops.projection import preprocess_gaussians_hv as j_pg_hv
from lidargs_torch.config import RasterConfig as TCfg
from lidargs_torch.ops.projection import preprocess_gaussians, preprocess_gaussians_hv
from lidargs_torch.utils.testing import one_torch_thread
from test_projection_vjp import RCFG as JCFG
from test_projection_vjp import W, _scene


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


TCFG = TCfg(max_visible=2048, tile_capacity=64, chunk=8)
OUT_FIELDS = ("depth", "sphere_mean", "u1", "u2", "conic", "opacity", "feat", "center")
DIFF = (0, 1, 2, 3, 4, 6, 7)           # means, scales, quats, opacities, feat, rot, trans
NAMES = ("means", "scales", "quats", "opacities", "feat", "w2s_rot", "w2s_trans")


def _np_scene(seed):
    return [np.array(a) for a in _scene(seed=seed)]


def _cotangents(args, seed):
    """float32 cotangents for the differentiable outputs (so they survive
    the outputs' float32 cast exactly)."""
    out = preprocess_gaussians(*[torch.from_numpy(a) for a in args], W, TCFG)
    rng = np.random.default_rng(seed)
    return {f: rng.normal(size=tuple(getattr(out, f).shape)).astype(np.float32)
            for f in OUT_FIELDS}


def _torch_grads(fn, args, ct, dtype, fields=OUT_FIELDS):
    ts = []
    for i, a in enumerate(args):
        t = torch.from_numpy(a)
        if t.is_floating_point():
            t = t.to(dtype).requires_grad_(i in DIFF or i == 8)
        ts.append(t)
    out = fn(*ts, W, TCFG)
    loss = sum((getattr(out, f).to(dtype) * torch.from_numpy(ct[f]).to(dtype)).sum()
               for f in fields)
    wrt = [ts[i] for i in DIFF] + [ts[8]]
    grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    return out, [torch.zeros_like(x) if g is None else g for g, x in zip(grads, wrt)]


@pytest.mark.parametrize("seed", [0, 2])
def test_hand_vjp_matches_autograd_f64(seed):
    args = _np_scene(seed)
    ct = _cotangents(args, seed + 10)
    out_hv, g_hv = _torch_grads(preprocess_gaussians_hv, args, ct, torch.float64)
    out_ad, g_ad = _torch_grads(preprocess_gaussians, args, ct, torch.float64)
    for a, b in zip(out_hv, out_ad):                 # the same forward
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())
    valid = out_hv.valid.numpy()
    assert 0 < valid.sum() < valid.size              # culled rows are present
    for nm, a, b in zip(NAMES, g_hv[:-1], g_ad[:-1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-10,
                                   err_msg=f"cotangent of {nm}")
    # beams: autograd reaches the table, the hand VJP gives it zero
    assert float(g_ad[-1].abs().sum()) > 0.0
    np.testing.assert_array_equal(g_hv[-1].numpy(), 0.0)
    for nm in ("valid", "radii_xy", "pix_rect"):
        assert not getattr(out_hv, nm).requires_grad


def test_hand_vjp_partial_cotangents_f64():
    """Only some outputs used: the missing cotangents act as zeros."""
    args = _np_scene(5)
    ct = _cotangents(args, 3)
    fields = ("conic", "center")
    _, g_hv = _torch_grads(preprocess_gaussians_hv, args, ct, torch.float64, fields)
    _, g_ad = _torch_grads(preprocess_gaussians, args, ct, torch.float64, fields)
    for nm, a, b in zip(NAMES, g_hv[:-1], g_ad[:-1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-10,
                                   err_msg=f"cotangent of {nm}")


@pytest.mark.parametrize("seed", [0, 3])
def test_hand_vjp_matches_jax_f32(seed):
    args = _np_scene(seed)
    ct = _cotangents(args, seed + 10)
    _, g_t = _torch_grads(preprocess_gaussians_hv, args, ct, torch.float32)

    def f(*d):
        a = [jnp.asarray(x) for x in args]
        for i, v in zip(DIFF, d):
            a[i] = v
        out = j_pg_hv(*a, W, JCFG)
        return sum(jnp.vdot(getattr(out, n), jnp.asarray(ct[n])) for n in OUT_FIELDS)

    g_j = jax.jit(jax.grad(f, argnums=tuple(range(len(DIFF)))))(
        *[jnp.asarray(args[i]) for i in DIFF])
    for nm, a, b in zip(NAMES, g_t[:-1], g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-4,
                                   err_msg=f"cotangent of {nm}")
