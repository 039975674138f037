"""Kernels K5 and K6: the port's plain surfel composite and its plain VJP
against the JAX package's Pallas kernel bodies, and the CUDA kernels against
the plain versions.

On the CPU, the JAX package's `surfel_composite_tiles` (backend "pallas")
and `_bwd_call` run the TPU kernel bodies `_fwd_tile` and `_bwd_tile` in
interpret mode, so the plain versions are held to the TPU kernels on the
same [T, K, F] / [T] / [T, 8, NPIX] inputs, as the JAX package's own tests
hold those kernels to its scan.

Tolerances, each with its reason:
  * forward: atol 1e-5 on the features, T and normal, 1e-4 m on the depth
    and the median depth, 1e-5 on the distortion and M1/M2, on all but 1% of
    the elements (`assert_close_up_to_flips`: a pixel at the 1e-4
    transmittance threshold may stop one surfel apart; the median at
    T-before = 0.5 likewise), with a max of 2e-2 (2 m on depths).
  * backward: each of the 16 + C gradient columns of dinst scaled by its
    largest magnitude, over the rows that either side touches (most rows
    are zero, and a narrow column such as d_center is live on the rho2d
    rows alone): a mean within 1e-6, at most 4 elements beyond 2e-5, none
    beyond 1e-3; the rows neither side touches are zero in both. Both sides
    run the chunked rule, so nothing flips. Measured against the Pallas
    body: a mean of 8.2e-8, a max of 2.3e-5 and one element beyond 2e-5
    over 873 touched rows (case 0), a max of 1.9e-6 (case 1); against
    autograd of the plain forward a max of 2.7e-6. A d_center off by 0.5%
    fails (max 5e-3, 5-6 elements beyond). Each side differentiates at its OWN forward's
    output: the median's cotangent goes to the row whose recomputed depth
    equals the saved median bit for bit, and XLA and PyTorch round a pair's
    depth differently (XLA contracts into FMAs).
  * the CUDA kernels against the plain versions: the forward bounds above;
    the backward's with at most 64 elements beyond 2e-5, as `chip_smoke.py`
    allows K6 (a pixel at the threshold can stop one surfel apart).

The backward bound also holds the plain version to the Pallas body on
inputs made for K6's row reduction (`_edge_inputs`): every other row's rect
shrunk to one pixel, so at most one lane of a warp applies it, and six
opaque rows in front of every list, so every pixel is done within the
kernel's first chunk of rows. A block of 100 pixels (the last warp partial)
has no Pallas counterpart: the plain version on those pixels is held to it
on the whole block with a zero cotangent on the others.

The CUDA cases need a card and nvcc; they are marked `cuda` and skip here.
On the card, K6 on the three edge cases is held to the plain version, two
launches to each other bit for bit, and K8 on windows of one buffer holding
the same rows to K6 scattered to the windows, bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidargs_tpu.config import RasterConfig as JCfg
from lidargs_tpu.ops import rasterize as jr
from lidargs_tpu.ops import surfel as js
from lidargs_tpu.ops.pallas_surfel import OUT_ROWS, _bwd_call, surfel_composite_tiles
from lidargs_torch.config import RasterConfig as TCfg
from lidargs_torch.ops import surfel_kernel as sk
from lidargs_torch.utils.testing import assert_close_up_to_flips, make_scene, one_torch_thread
from test_torch_composite_bwd import EDGE_KINDS, N_FRONT, _windows_of


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


C = 2
NV = 16 + C          # gradient columns through the center

CASES = [
    dict(seed=0, n=160, H=16, W=256, tile_capacity=64),
    # an opaque pile-up: transmittance saturates and the early exit fires
    dict(seed=1, n=300, H=8, W=128, tile_capacity=128, scale=(2.0, 4.0), opaque=True),
    dict(seed=2, n=120, H=8, W=128, tile_capacity=128, tile_h=4),
]


def _surfel_inputs(seed, n, H, W, scale=(0.3, 1.2), opaque=False, **kw):
    """[T,K,F] surfels, [T] counts and [T,8,NPIX] pixel blocks as the JAX
    render path builds them for its composite kernel (numpy)."""
    cfg = JCfg(max_visible=512, max_tiles_per_gaussian=64, chunk=8, pallas_chunk=8,
               backend="pallas", **kw)
    sc = make_scene(seed, n=n, H=H, W=W)
    rng = np.random.default_rng(seed + 50)
    scales2 = rng.uniform(*scale, (n, 2)).astype(np.float32)
    opac = rng.uniform(0.9, 1.0, n).astype(np.float32) if opaque else sc.opacities
    beams = jnp.asarray(sc.beams)

    @jax.jit
    def build(m, s, q, o, f, mask, rot, trans):
        pk = js.preprocess_surfels(m, s, q, o, f, mask, rot, trans, beams, W, cfg)
        S = js.SurfelCols
        _, sel = jax.lax.sort((pk[:, S.DEPTH], jnp.arange(n, dtype=jnp.int32)), num_keys=1,
                              is_stable=True)
        pkv = jr.permutation_rows(pk, sel, min(cfg.max_visible, n))
        gy, gx = cfg.grid_shape(H, W)
        ids, counts, _ = jr.bin_instances(pkv[:, S.rect(C)].astype(jnp.int32),
                                          pkv[:, S.center(C)], pkv[:, S.validf(C)] > 0.0,
                                          cfg, gx, gy)
        inst = jnp.take(pkv, ids.reshape(-1), axis=0, mode="clip").reshape(
            gy * gx, cfg.tile_capacity, -1)
        px, py, dirs = jr._tile_pixels(H, W, cfg, gx, gy, beams)
        return inst, counts, jr._pix_blocks(px, py, dirs)

    out = build(sc.means3d, scales2, sc.quats, opac, sc.feat, sc.mask, sc.w2s_rot, sc.w2s_trans)
    return (cfg,) + tuple(np.array(x) for x in out)


def _case(case):
    """(JAX config, port config, inst, counts, pix) of one of CASES, built
    once per process; the arrays are shared, so callers copy before writing."""
    return _case_at(CASES.index(case))


@functools.lru_cache(maxsize=None)
def _case_at(i):
    case = dict(CASES[i])
    seed, n, H, W = (case.pop(k) for k in ("seed", "n", "H", "W"))
    extra = {k: case.pop(k) for k in ("scale", "opaque") if k in case}
    jcfg, inst, counts, pix = _surfel_inputs(seed, n, H, W, **extra, **case)
    tcfg = TCfg(max_visible=512, max_tiles_per_gaussian=64, chunk=8, **case)
    return jcfg, tcfg, inst, counts, pix


@functools.lru_cache(maxsize=None)
def _pallas_fwd(i):
    """The JAX package's forward (the Pallas body, interpret mode) on CASES[i]."""
    jcfg, _, inst, counts, pix = _case_at(i)
    return np.asarray(jax.jit(lambda a, b, c: surfel_composite_tiles(a, b, c, C, jcfg))(
        inst, counts, pix))


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _compare_out(out, ref):
    rows = list(range(C)) + [C + 1, C + 2, C + 3, C + 4]
    assert_close_up_to_flips(out[:, rows], ref[:, rows], 1e-5, 2e-2,
                             what="features, T, normal")
    assert_close_up_to_flips(out[:, [C, C + 5]], ref[:, [C, C + 5]], 1e-4, 2.0,
                             what="depth, median")
    assert_close_up_to_flips(out[:, C + 6:C + 9], ref[:, C + 6:C + 9], 1e-5, 2e-2,
                             what="distortion, M1, M2")
    np.testing.assert_array_equal(out[:, C + 9:], 0.0)


def _compare_dinst(got, want, far_count=4):
    """The backward bound of the docstring: columns scaled, over the rows
    either side touches."""
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., js.SurfelCols.DEPTH], 0.0)
    np.testing.assert_array_equal(got[..., NV:], 0.0)      # rect, valid, pad
    g, w = got[..., :NV], want[..., :NV]
    touched = (np.abs(g).max(-1) > 0) | (np.abs(w).max(-1) > 0)
    scale = np.maximum(np.abs(w).max(axis=(0, 1)), 1e-30)
    d = np.abs(g[touched] - w[touched]) / scale           # [touched rows, NV]
    err = dict(mean=d.mean(), max=d.max(), far=int((d > 2e-5).sum()),
               far_per_column=(d > 2e-5).sum(0).tolist(), rows=int(touched.sum()))
    assert err["mean"] <= 1e-6 and err["far"] <= far_count and err["max"] <= 1e-3, err


def _cotangent(shape, seed):
    """A random cotangent on every row the forward writes (C + 9)."""
    g = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    g[:, C + 9:] = 0.0
    return g


def _edge_inputs(kind):
    """CASES[0]'s inputs (copied), made for one path of K6's row reduction:
      partial_warp: the first 100 pixels of each tile's 128;
      single_lane: every other row's parity rect shrunk to the one pixel at
        its center;
      first_chunk: a scene 2048 columns wide (a tile spans 22.5 degrees),
        with N_FRONT rows in front of each list, each a plane facing the
        tile's mean ray 10 m out with 100 m axes (rho < 1e-3, alpha ~
        opacity 0.8 on every pixel) and a rect over the whole tile, so every
        pixel crosses at the last of them, and every list full;
    with a random cotangent on every row the forward writes."""
    jcfg, tcfg, inst, counts, pix = _case_at(0)
    if kind == "first_chunk":
        jcfg, inst, counts, pix = _surfel_inputs(0, 160, 8, 2048, tile_capacity=64)
    inst, counts = inst.copy(), counts.copy()
    S = js.SurfelCols
    rc = S.rect(C)
    T, K, _ = inst.shape
    g = _cotangent((T, OUT_ROWS, pix.shape[2]), 12)
    if kind == "partial_warp":
        return jcfg, tcfg, inst, counts, np.ascontiguousarray(pix[:, :, :100]), g[:, :, :100]
    if kind == "single_lane":
        r = inst[:, ::2, rc]
        xc = np.clip(np.floor((r[..., 0] + r[..., 1]) / 2), r[..., 0], r[..., 1] - 1)
        yc = np.clip(np.floor((r[..., 2] + r[..., 3]) / 2), r[..., 2], r[..., 3] - 1)
        inst[:, ::2, rc] = np.stack([xc, xc + 1, yc, yc + 1], -1)
        return jcfg, tcfg, inst, counts, pix, g
    m = pix[:, 0:3].mean(-1)
    m /= np.linalg.norm(m, axis=-1, keepdims=True)               # [T, 3] mean ray
    u = np.cross(m, [0.0, 0.0, 1.0])
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    v = np.cross(m, u)
    front = np.zeros((T, N_FRONT, inst.shape[2]), np.float32)
    front[..., S.TU] = 100.0 * u[:, None]
    front[..., S.TV] = 100.0 * v[:, None]
    front[..., S.TW] = 10.0 * m[:, None]
    front[..., S.NORMAL] = -m[:, None]
    front[..., S.OPACITY] = 0.8
    front[..., S.DEPTH] = 10.0
    front[..., S.FEAT0:S.FEAT0 + C] = np.random.default_rng(5).uniform(size=(T, N_FRONT, C))
    front[..., S.center(C)] = np.stack([pix[:, 3].mean(-1), pix[:, 4].mean(-1)], -1)[:, None]
    front[..., rc] = [-1e6, 1e6, -1e6, 1e6]
    front[..., S.validf(C)] = 1.0
    inst = np.concatenate([front, inst[:, :K - N_FRONT]], 1)
    return jcfg, tcfg, inst, np.full_like(counts, K), pix, g


@pytest.mark.parametrize("case", CASES)
def test_plain_fwd_matches_pallas_kernel_body(case):
    _, tcfg, inst, counts, pix = _case(case)
    ref = _pallas_fwd(CASES.index(case))
    out = sk.surfel_composite_tiles_plain(*_t(inst, counts, pix), C, tcfg).numpy()
    assert out.shape == ref.shape == (pix.shape[0], OUT_ROWS, pix.shape[2])
    _compare_out(out, ref)
    T_final = ref[:, C + 1]
    assert T_final.min() < 0.05 and (ref[:, C + 5] > 0).any() and (ref[:, C + 6] > 0).any()
    if case.get("opaque"):
        assert (T_final < 1e-2).mean() > 0.05         # the pile-up saturates


@pytest.mark.parametrize("case", CASES[:2])
def test_plain_bwd_matches_pallas_kernel_body(case):
    jcfg, tcfg, inst, counts, pix = _case(case)
    res_j = _pallas_fwd(CASES.index(case))
    g = _cotangent(res_j.shape, 7)
    want = np.asarray(jax.jit(lambda *a: _bwd_call(*a, C, jcfg))(inst, counts, pix, res_j, g))
    ti, tn, tp = _t(inst, counts, pix)
    res_t = sk.surfel_composite_tiles_plain(ti, tn, tp, C, tcfg)
    got = sk.surfel_composite_tiles_bwd_plain(ti, tn, tp, res_t, torch.from_numpy(g), C,
                                              tcfg).numpy()
    _compare_dinst(got, want)
    assert (np.abs(want[..., :NV]).max(-1) > 0).sum() > 100   # many rows carry gradient
    if not case.get("opaque"):
        # small surfels: the rho2d fallback, and with it the center chain, is live
        assert np.abs(want[..., js.SurfelCols.center(C)]).max() > 0
    else:
        # behind each tile's early exit the rows are zero in both
        walked = np.abs(want).max(-1) > 0
        last = np.where(walked.any(1), walked.shape[1] - 1 - np.argmax(walked[:, ::-1], 1), -1)
        assert (last < counts - 1).any()


@pytest.mark.parametrize("kind", EDGE_KINDS)
def test_plain_bwd_on_the_reduction_edge_cases(kind):
    """Each side at its own forward's output, as above."""
    jcfg, tcfg, inst, counts, pix, g = _edge_inputs(kind)
    ti, tn, tp = _t(inst, counts, pix)
    res_t = sk.surfel_composite_tiles_plain(ti, tn, tp, C, tcfg)
    got = sk.surfel_composite_tiles_bwd_plain(ti, tn, tp, res_t, torch.from_numpy(g), C,
                                              tcfg).numpy()
    if kind == "partial_warp":
        _, _, _, _, pix_all = _case_at(0)
        g_all = _cotangent((pix_all.shape[0], OUT_ROWS, pix_all.shape[2]), 12)
        g_all[:, :, 100:] = 0.0
        ta, tg = _t(pix_all, g_all)
        full = sk.surfel_composite_tiles_bwd_plain(
            ti, tn, ta, sk.surfel_composite_tiles_plain(ti, tn, ta, C, tcfg), tg, C,
            tcfg).numpy()
        assert pix.shape[2] % 32 != 0
        _compare_dinst(got, full)
        return
    res_j = np.asarray(jax.jit(lambda a, b, c: surfel_composite_tiles(a, b, c, C, jcfg))(
        inst, counts, pix))
    want = np.asarray(jax.jit(lambda *a: _bwd_call(*a, C, jcfg))(inst, counts, pix, res_j, g))
    _compare_dinst(got, want)
    touched = np.abs(want[..., :NV]).max(-1) > 0
    if kind == "single_lane":
        assert touched[:, ::2].sum() > 20             # one-pixel rows that a pixel applied
    else:
        live = counts > 0
        assert touched[live, :N_FRONT - 1].all()      # every pixel applied the opaque rows
        assert not touched[:, N_FRONT - 1:].any()     # and crossed at the last of them


def test_plain_bwd_matches_autograd_of_plain_fwd():
    _, tcfg, inst, counts, pix = _case(CASES[0])
    x = torch.from_numpy(inst).requires_grad_(True)
    tn, tp = _t(counts, pix)
    out = sk.surfel_composite_tiles_plain(x, tn, tp, C, tcfg)
    g = torch.from_numpy(_cotangent(tuple(out.shape), 8))
    out.backward(g)
    got = sk.surfel_composite_tiles_bwd_plain(torch.from_numpy(inst), tn, tp, out.detach(), g,
                                              C, tcfg).numpy()
    want = x.grad.numpy().copy()
    want[..., js.SurfelCols.DEPTH] = 0.0          # the scan reads the range from Tw instead
    _compare_dinst(got, want)


def test_autograd_function_and_wrappers_on_cpu():
    """SurfelCompositeTiles on CPU tensors: forward and backward are the
    plain versions, nothing is launched, and a device that is neither CPU
    nor CUDA is refused."""
    _, tcfg, inst, counts, pix = _case(CASES[2])
    ti, tn, tp = _t(inst, counts, pix)
    x = ti.clone().requires_grad_(True)
    before = (sk.launches, sk.bwd_launches)
    out = sk.SurfelCompositeTiles.apply(x, tn, tp, C, tcfg)
    g = torch.from_numpy(_cotangent(tuple(out.shape), 9))
    out.backward(g)
    assert (sk.launches, sk.bwd_launches) == before
    np.testing.assert_array_equal(out.detach().numpy(),
                                  sk.surfel_composite_tiles_plain(ti, tn, tp, C, tcfg).numpy())
    np.testing.assert_array_equal(
        x.grad.numpy(),
        sk.surfel_composite_tiles_bwd_plain(ti, tn, tp, out.detach(), g, C, tcfg).numpy())
    meta = [a.to("meta") for a in (ti, tn, tp)]
    with pytest.raises(ValueError, match="unsupported device"):
        sk.surfel_composite_tiles(*meta, C, tcfg)
    with pytest.raises(ValueError, match="unsupported device"):
        sk.surfel_composite_tiles_bwd(*meta, out.to("meta"), g.to("meta"), C, tcfg)


@pytest.mark.parametrize("bad,err", [
    (dict(counts=torch.zeros(3, dtype=torch.int64)), TypeError),     # int32 counts
    (dict(inst=torch.zeros(3, 8, 24, dtype=torch.float64)), TypeError),
    (dict(pix=torch.zeros(3, 5, 128)), ValueError),                  # 8 pixel rows
    (dict(pix=torch.zeros(3, 8, 2048)), ValueError),                 # NPIX <= 1024
    (dict(inst=torch.zeros(3, 8, 22)), ValueError),                  # narrower than SurfelCols
    (dict(inst=torch.zeros(3, 24, 8).transpose(1, 2)), ValueError),  # not contiguous
    (dict(C=8), ValueError),                                         # C + 9 > 16 rows
    (dict(res=torch.zeros(3, 8, 128)), ValueError),                  # [T, 16, NPIX]
    (dict(g=torch.zeros(3, 16, 128, dtype=torch.float64)), TypeError),
])
def test_kernel_input_checks_raise(bad, err):
    """The checks the wrappers run before a launch (the kernels take no
    other layout) refuse what K5 and K6 cannot take."""
    from lidargs_torch.ops.composite_kernel import check_saved, check_tile_inputs

    a = dict(inst=torch.zeros(3, 8, 24), counts=torch.zeros(3, dtype=torch.int32),
             pix=torch.zeros(3, 8, 128), res=torch.zeros(3, 16, 128),
             g=torch.zeros(3, 16, 128), C=C)
    check_tile_inputs(a["inst"], a["counts"], a["pix"], C, sk.OUT_ROWS - 9, NV + 5)
    check_saved(a["inst"], a["pix"], sk.OUT_ROWS, res=a["res"], g=a["g"])
    a.update(bad)
    with pytest.raises(err):
        check_tile_inputs(a["inst"], a["counts"], a["pix"], a["C"], sk.OUT_ROWS - 9,
                          js.SurfelCols.validf(a["C"]) + 1)
        check_saved(a["inst"], a["pix"], sk.OUT_ROWS, res=a["res"], g=a["g"])


@pytest.mark.cuda
def test_cuda_kernels_match_plain_on_card():
    """K5 and K6 against the plain versions on the same CUDA tensors (the
    pile-up case, whose early exit fires), each backward at K5's output. The
    kernels walk each pixel in sequence where the plain versions take a
    chunked cumprod: the forward and backward bounds above. Two K6 launches
    give the same bits (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    _, tcfg, inst, counts, pix = _case(CASES[1])
    dev = torch.device("cuda")
    args = [x.to(dev) for x in _t(inst, counts, pix)]
    before = (sk.launches, sk.bwd_launches)
    out = sk.surfel_composite_tiles(*args, C, tcfg)
    g = torch.from_numpy(_cotangent(tuple(out.shape), 10)).to(dev)
    d1 = sk.surfel_composite_tiles_bwd(*args, out, g, C, tcfg)
    d2 = sk.surfel_composite_tiles_bwd(*args, out, g, C, tcfg)
    torch.cuda.synchronize()
    assert (sk.launches, sk.bwd_launches) == (before[0] + 1, before[1] + 2)
    assert torch.equal(d1, d2)
    _compare_out(out.cpu().numpy(), sk.surfel_composite_tiles_plain(*args, C, tcfg).cpu().numpy())
    ref = sk.surfel_composite_tiles_bwd_plain(*args, out, g, C, tcfg)
    _compare_dinst(d1.cpu().numpy(), ref.cpu().numpy(), far_count=64)
    with pytest.raises(TypeError, match="int32"):
        sk.surfel_composite_tiles(args[0], args[1].long(), args[2], C, tcfg)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", EDGE_KINDS)
def test_cuda_bwd_reduction_paths_on_card(kind):
    """K6 on the edge cases of its row reduction (a partial warp, rows one
    lane applies, every pixel done in the first chunk), at K5's output,
    against the plain version, two launches bit for bit, and K8 on windows
    of one buffer holding the same rows equal to K6 scattered to the
    windows, every other row zero, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    _, tcfg, inst, counts, pix, g = _edge_inputs(kind)
    dev = torch.device("cuda")
    ti, tc, tp, tg = [x.to(dev) for x in _t(inst, counts, pix, g)]
    res = sk.surfel_composite_tiles(ti, tc, tp, C, tcfg)
    d1 = sk.surfel_composite_tiles_bwd(ti, tc, tp, res, tg, C, tcfg)
    d2 = sk.surfel_composite_tiles_bwd(ti, tc, tp, res, tg, C, tcfg)
    buf, starts = _windows_of(ti, tc)
    w1 = sk.surfel_composite_windows_bwd(buf, starts, tc, tp, res, tg, C, tcfg)
    w2 = sk.surfel_composite_windows_bwd(buf, starts, tc, tp, res, tg, C, tcfg)
    torch.cuda.synchronize()
    assert torch.equal(d1, d2) and torch.equal(w1, w2)
    assert torch.equal(w1, sk.scatter_windows(d1, starts, tc, buf.shape[0]))
    ref = sk.surfel_composite_tiles_bwd_plain(ti, tc, tp, res, tg, C, tcfg)
    _compare_dinst(d1.cpu().numpy(), ref.cpu().numpy(), far_count=64)
