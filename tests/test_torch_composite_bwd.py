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

The same bound holds the plain version to the Pallas body on inputs made
for the kernel's row reduction (`_edge_inputs`): every other row's rect
shrunk to one pixel, so at most one lane of a warp applies it, and six
opaque rows in front of every list, so every pixel is done within the
kernel's first chunk of rows. A third case, a block of 100 pixels (the
last warp partial), has no Pallas counterpart (the TPU kernel takes whole
128-lane rows): the plain version on those pixels is held to it on the
whole block with a zero cotangent on the others, which adds nothing.

The CUDA cases need a card and nvcc; they are marked `cuda` and skip here.
On the card, K2 on the three edge cases is held to the plain version, two
launches to each other bit for bit, and K4 on windows of one buffer holding
the same rows to K2 scattered to the windows, bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

from lidargs_tpu.ops.pallas_composite import _bwd_call, composite_tiles_pallas
from lidargs_torch.config import RasterConfig as TCfg
from lidargs_torch.ops import composite_kernel as ck
from lidargs_torch.ops.projection import PackedCols as PC
from lidargs_torch.utils.stage_split import counting
from lidargs_torch.utils.testing import assert_close_up_to_flips, one_torch_thread
from test_torch_composite_kernel import _kernel_inputs


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


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


EDGE_KINDS = ("partial_warp", "single_lane", "first_chunk")
N_FRONT = 6          # opaque rows in front: 0.2^5 > 1e-4 > 0.2^6, so each pixel crosses at the sixth


def _edge_inputs(kind, g_seed=11):
    """CASES[0]'s inputs, made for one path of K2's row reduction:
      partial_warp: the first 100 pixels of each tile's 128;
      single_lane: every other row's parity rect shrunk to the one pixel at
        its center (at most one lane, of one warp, can apply it);
      first_chunk: N_FRONT rows in front of each list with a zero conic
        (power 0, alpha = opacity 0.8 on every pixel) and a rect over the
        whole tile, so every pixel crosses at the last of them;
    with the JAX forward's output (None for partial_warp, whose 100-pixel
    blocks the Pallas kernel does not take) and a random cotangent."""
    jcfg, tcfg, inst, counts, pix, res, g = _case(CASES[0], g_seed)
    inst, counts = inst.copy(), counts.copy()
    rc = PC.rect(C)
    K = inst.shape[1]
    if kind == "partial_warp":
        return jcfg, tcfg, inst, counts, np.ascontiguousarray(pix[:, :, :100]), None, \
            np.ascontiguousarray(g[:, :, :100])
    if kind == "single_lane":
        r = inst[:, ::2, rc]
        xc = np.clip(np.floor((r[..., 0] + r[..., 1]) / 2), r[..., 0], r[..., 1] - 1)
        yc = np.clip(np.floor((r[..., 2] + r[..., 3]) / 2), r[..., 2], r[..., 3] - 1)
        inst[:, ::2, rc] = np.stack([xc, xc + 1, yc, yc + 1], -1)
    else:
        front = np.zeros((inst.shape[0], N_FRONT, inst.shape[2]), np.float32)
        front[..., 3], front[..., 7] = 1.0, 1.0                 # u1 = x, u2 = y; conic 0
        front[..., PC.OPACITY] = 0.8
        front[..., PC.DEPTH] = 5.0
        front[..., PC.FEAT0:PC.FEAT0 + C] = np.random.default_rng(5).uniform(
            size=(inst.shape[0], N_FRONT, C))
        front[..., rc] = [-1e6, 1e6, -1e6, 1e6]
        inst = np.concatenate([front, inst[:, :K - N_FRONT]], 1)
        counts = np.minimum(counts + N_FRONT, K).astype(np.int32)
    res = np.asarray(jax.jit(lambda a, b, c: composite_tiles_pallas(a, b, c, C, jcfg))(
        inst, counts, pix))
    return jcfg, tcfg, inst, counts, pix, res, g


def _windows_of(inst, counts, gap=3):
    """One buffer holding each tile's rows [0, count) at rows [starts[t],
    starts[t] + count), `gap` rows apart, with K zero rows at its end (so
    each window [starts[t], starts[t] + K) overlaps the next tiles' rows,
    as the binning's windows do), and the int32 starts."""
    T, K, Fw = inst.shape
    c = counts.clamp(0, K).long()
    starts = torch.cumsum(c + gap, 0) - (c + gap)
    k = torch.arange(K, device=inst.device)[None, :]
    own = k < c[:, None]
    buf = torch.zeros((int(starts[-1]) + K, Fw), dtype=inst.dtype, device=inst.device)
    buf[(starts[:, None] + k)[own]] = inst[own]
    return buf, starts.to(torch.int32)


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


@pytest.mark.parametrize("kind", EDGE_KINDS)
def test_plain_bwd_on_the_reduction_edge_cases(kind):
    jcfg, tcfg, inst, counts, pix, res, g = _edge_inputs(kind)
    t = [torch.from_numpy(x) for x in (inst, counts, pix)]
    if kind == "partial_warp":
        # the plain version on the first 100 pixels against it on all 128,
        # the others given a zero cotangent
        _, _, _, _, pix_all, _, g_all = _case(CASES[0], 11)
        g_all = g_all.copy()
        g_all[:, :, 100:] = 0.0
        ta = [torch.from_numpy(x) for x in (pix_all, g_all)]
        full = ck.composite_tiles_bwd_plain(t[0], t[1], ta[0],
                                            ck.composite_tiles_plain(t[0], t[1], ta[0], C, tcfg),
                                            ta[1], C, tcfg).numpy()
        res_t = ck.composite_tiles_plain(*t, C, tcfg)
        got = ck.composite_tiles_bwd_plain(*t, res_t, torch.from_numpy(g), C, tcfg).numpy()
        assert pix.shape[2] % 32 != 0
        _compare_dinst(got, full)
        return
    want = np.asarray(jax.jit(lambda *a: _bwd_call(*a, C, jcfg))(inst, counts, pix, res, g))
    got = ck.composite_tiles_bwd_plain(*t, torch.from_numpy(res), torch.from_numpy(g), C,
                                       tcfg).numpy()
    _compare_dinst(got, want)
    touched = np.abs(want[..., :NV]).max(-1) > 0
    if kind == "single_lane":
        assert touched[:, ::2].sum() > 20             # one-pixel rows that a pixel applied
    else:
        live = counts > 0
        assert touched[live, :N_FRONT - 1].all()      # every pixel applied the opaque rows
        assert not touched[:, N_FRONT - 1:].any()     # and crossed at the last of them
        assert (counts > 32).any()


def test_autograd_function_matches_jax_vjp():
    jcfg, tcfg, inst, counts, pix, res, g = _case(CASES[1], g_seed=8)
    out_j, vjp = jax.vjp(lambda a: composite_tiles_pallas(a, counts, pix, C, jcfg), inst)
    (d_j,) = vjp(g)
    x = torch.from_numpy(inst).requires_grad_(True)
    with counting() as n:
        out_t = ck.CompositeTiles.apply(x, torch.from_numpy(counts), torch.from_numpy(pix), C,
                                        tcfg)
        out_t.backward(torch.from_numpy(g))
    assert not any(n.values())          # the CPU path launches nothing
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
    with counting() as n:
        d1 = ck.composite_tiles_bwd(*args, res_k, g_t, C, tcfg)
        d2 = ck.composite_tiles_bwd(*args, res_k, g_t, C, tcfg)
        torch.cuda.synchronize()
    assert n["K2"] == 2
    assert torch.equal(d1, d2)
    ref = ck.composite_tiles_bwd_plain(*args, res_k, g_t, C, tcfg)
    _compare_dinst(d1.cpu().numpy(), ref.cpu().numpy())
    with pytest.raises(TypeError, match="float32"):
        ck.composite_tiles_bwd(*args, res_k, g_t.double(), C, tcfg)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", EDGE_KINDS)
def test_cuda_bwd_reduction_paths_on_card(kind):
    """K2 on the edge cases of its row reduction (a partial warp, rows one
    lane applies, every pixel done in the first chunk) against the plain
    version, two launches bit for bit, and K4 on windows of one buffer
    holding the same rows equal to K2 scattered to the windows, every other
    row zero, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    _, tcfg, inst, counts, pix, _, g = _edge_inputs(kind)
    dev = torch.device("cuda")
    ti, tc, tp, tg = [torch.from_numpy(x).to(dev) for x in (inst, counts, pix, g)]
    res = ck.composite_tiles(ti, tc, tp, C, tcfg)
    d1 = ck.composite_tiles_bwd(ti, tc, tp, res, tg, C, tcfg)
    d2 = ck.composite_tiles_bwd(ti, tc, tp, res, tg, C, tcfg)
    buf, starts = _windows_of(ti, tc)
    w1 = ck.composite_windows_bwd(buf, starts, tc, tp, res, tg, C, tcfg)
    w2 = ck.composite_windows_bwd(buf, starts, tc, tp, res, tg, C, tcfg)
    torch.cuda.synchronize()
    assert torch.equal(d1, d2) and torch.equal(w1, w2)
    assert torch.equal(w1, ck.scatter_windows(d1, starts, tc, buf.shape[0]))
    ref = ck.composite_tiles_bwd_plain(ti, tc, tp, res, tg, C, tcfg)
    _compare_dinst(d1.cpu().numpy(), ref.cpu().numpy())
