"""Kernel K2: the port's plain backward composite against the JAX package's
Pallas kernel body, the autograd function against the JAX custom VJP, and
the CUDA kernel against the plain version.

On the CPU, `_bwd_call` runs the TPU kernel body `_bwd_tile` in interpret
mode, so `composite_tiles_bwd_plain` is held to the TPU kernel itself on
identical inputs (the instances, counts and pixel blocks of the JAX render
path, K1's output and a random cotangent). Both take the same chunked
transmittance rule, so they agree to f32 rounding: each column of dinst,
scaled by its largest magnitude, within 2e-5 on all but 1% of the elements.
A pixel whose walk stops one instance apart at the 1e-4 threshold moves
that instance's row by up to the whole scale, hence the max bound of 1.0.

The CUDA case needs a card and nvcc; it is marked `cuda` and skips here.
"""
import jax
import numpy as np
import pytest
import torch

from lidargs_tpu.ops.pallas_composite import _bwd_call, composite_tiles_pallas
from lidargs_torch.config import RasterConfig as TCfg
from lidargs_torch.ops import composite_kernel as ck
from lidargs_torch.utils.testing import assert_close_up_to_flips
from test_torch_composite_kernel import _kernel_inputs

C = 2
NV = 14 + C          # gradient columns: mean, u1, u2, conic, opacity, depth, feat

CASES = [
    dict(seed=0, n=200, H=16, W=256, tile_capacity=64),
    # opaque pile-up: transmittance saturates, so the kernel's early exit
    # fires and the rows behind it must read zero
    dict(seed=1, n=400, H=16, W=128, tile_capacity=128, scale_px=8.0),
    dict(seed=2, n=150, H=8, W=128, tile_capacity=128, tile_h=4),
]


def _case(case, g_seed=7):
    """JAX kernel inputs, K1's output on them and a random cotangent."""
    case = dict(case)
    seed, n, H, W = (case.pop(k) for k in ("seed", "n", "H", "W"))
    scale_px = case.pop("scale_px", 2.0)
    jcfg, inst, counts, pix = _kernel_inputs(seed, n, H, W, scale_px, **case)
    res = np.asarray(jax.jit(lambda a, b, c: composite_tiles_pallas(a, b, c, C, jcfg))(
        inst, counts, pix))
    g = np.random.default_rng(g_seed).normal(size=pix.shape).astype(np.float32)
    g[:, C + 2:] = 0.0
    tcfg = TCfg(max_visible=512, max_tiles_per_gaussian=64, chunk=8, **case)
    return jcfg, tcfg, inst, counts, pix, res, g


def _compare_dinst(got, want):
    assert got.shape == want.shape
    scale = np.maximum(np.abs(want).max(axis=(0, 1)), 1e-30)
    assert_close_up_to_flips(got / scale, want / scale, 2e-5, 1.0, what="dinst / column scale")
    np.testing.assert_array_equal(got[..., NV:], 0.0)      # rect, center, valid, pad


@pytest.mark.parametrize("case", CASES)
def test_plain_bwd_matches_pallas_kernel_body(case):
    jcfg, tcfg, inst, counts, pix, res, g = _case(case)
    want = np.asarray(jax.jit(lambda *a: _bwd_call(*a, C, jcfg))(inst, counts, pix, res, g))
    got = ck.composite_tiles_bwd_plain(*[torch.from_numpy(x) for x in
                                         (inst, counts, pix, res, g)], C, tcfg).numpy()
    _compare_dinst(got, want)
    assert (np.abs(want[..., :NV]).max(-1) > 0).sum() > 100   # many rows carry gradient
    if "scale_px" in case:
        # behind each tile's early exit the rows are zero in both
        walked = np.abs(want).max(-1) > 0
        last = np.where(walked.any(1), walked.shape[1] - 1 - np.argmax(walked[:, ::-1], 1), -1)
        assert (last < counts - 1).any()


def test_autograd_function_matches_jax_vjp():
    jcfg, tcfg, inst, counts, pix, res, g = _case(CASES[1], g_seed=8)
    out_j, vjp = jax.vjp(lambda a: composite_tiles_pallas(a, counts, pix, C, jcfg), inst)
    (d_j,) = vjp(g)
    x = torch.from_numpy(inst).requires_grad_(True)
    before = (ck.launches, ck.bwd_launches)
    out_t = ck.CompositeTiles.apply(x, torch.from_numpy(counts), torch.from_numpy(pix), C, tcfg)
    out_t.backward(torch.from_numpy(g))
    assert (ck.launches, ck.bwd_launches) == before          # the CPU path launches nothing
    rows = list(range(C)) + [C + 1]
    assert_close_up_to_flips(out_t.detach().numpy()[:, rows], np.asarray(out_j)[:, rows],
                             1e-5, 2e-2, what="forward")
    _compare_dinst(x.grad.numpy(), np.asarray(d_j))


def test_bwd_wrapper_on_cpu_is_the_plain_version():
    _, tcfg, inst, counts, pix, res, g = _case(CASES[2])
    args = [torch.from_numpy(a) for a in (inst, counts, pix, res, g)]
    np.testing.assert_array_equal(ck.composite_tiles_bwd(*args, C, tcfg).numpy(),
                                  ck.composite_tiles_bwd_plain(*args, C, tcfg).numpy())
    with pytest.raises(ValueError, match="unsupported device"):
        ck.composite_tiles_bwd(*[a.to("meta") for a in args], C, tcfg)


@pytest.mark.cuda
def test_cuda_bwd_kernel_matches_plain_on_card():
    """K2 against the plain version on the same CUDA tensors (the pile-up
    case, whose early exit fires). The kernel walks each pixel in sequence
    where the plain version takes a chunked cumprod, so a pixel at the 1e-4
    threshold may stop one instance apart: the same column-scaled bound as
    above. Two launches give the same bits (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    _, tcfg, inst, counts, pix, res, g = _case(CASES[1])
    dev = torch.device("cuda")
    args = [torch.from_numpy(a).to(dev) for a in (inst, counts, pix)]
    res_k = ck.composite_tiles(*args, C, tcfg)       # K1's own output
    g_t = torch.from_numpy(g).to(dev)
    before = ck.bwd_launches
    d1 = ck.composite_tiles_bwd(*args, res_k, g_t, C, tcfg)
    d2 = ck.composite_tiles_bwd(*args, res_k, g_t, C, tcfg)
    torch.cuda.synchronize()
    assert ck.bwd_launches == before + 2
    assert torch.equal(d1, d2)
    ref = ck.composite_tiles_bwd_plain(*args, res_k, g_t, C, tcfg)
    _compare_dinst(d1.cpu().numpy(), ref.cpu().numpy())
    with pytest.raises(TypeError, match="float32"):
        ck.composite_tiles_bwd(*args, res_k, g_t.double(), C, tcfg)
