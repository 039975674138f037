"""The port's surfel (2DGS) preprocess and render against the JAX package on
the same numpy inputs.

Tolerances, each with its reason:
  * preprocess: the packed rows within 1e-4 relative to each column's
    largest magnitude, 5e-5 m on the depth column (both sides round
    atan2, the matrix products and the beam interpolation alike up to an
    ulp or two); the rect, valid and padding columns exactly, since they
    decide which pixels a surfel reaches. Gradients through the preprocess
    (autograd on both sides) within 1e-4 relative norm per input.
  * render, on the SAME packed rows: features, T and normal within 1e-5,
    depth and median depth within 5e-4 m (a 50 m pair's depth moves by its
    ulps), distortion within 1e-6, each on all but 1% of the elements
    (`assert_close_up_to_flips`: a pixel whose transmittance sits at the
    1e-4 stopping threshold may stop one surfel apart), with a max of 2e-2,
    2 m and 1e-3 on those; `n_overflow` and `n_dropped` exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidargs_tpu.config import RasterConfig as JR
from lidargs_tpu.ops import surfel as js
from lidargs_torch.config import RasterConfig as TR
from lidargs_torch.ops import surfel as ts
from lidargs_torch.utils.testing import assert_close_up_to_flips, make_scene, one_torch_thread


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


C = 2
RASTER = dict(max_visible=512, max_tiles_per_gaussian=64, tile_capacity=64, chunk=8)


def _inputs(seed, n=150, H=16, W=256, special=False):
    """Preprocess inputs as float32 numpy: a random scene with surfel scales,
    and with `special`, rows that hit each guard: a mean at the sensor, one
    straight above it, an edge-on surfel, one beyond `far` and one inside
    `near`."""
    sc = make_scene(seed, n=n, H=H, W=W)
    rng = np.random.default_rng(seed + 100)
    means, quats = sc.means3d.copy(), sc.quats.copy()
    scales2 = rng.uniform(0.3, 1.2, (n, 2)).astype(np.float32)
    if special:
        means[0] = 0.0                                  # at the sensor: masked
        means[1] = [0.0, 0.0, 10.0]                     # horiz2 = 0: degenerate
        means[2] = [10.0, 0.0, 0.0]                     # normal +z, center on x: edge-on
        quats[2] = [1.0, 0.0, 0.0, 0.0]
        means[3] = means[4] * (100.0 / np.linalg.norm(means[4]))   # beyond far
        means[5] = means[6] * (1.5 / np.linalg.norm(means[6]))     # inside near = 2
    return (means, scales2, quats, sc.opacities, sc.feat, sc.mask, sc.w2s_rot, sc.w2s_trans,
            sc.beams), W


def _compare_rows(got, want):
    S = ts.SurfelCols
    rv = slice(S.rect(C).start, None)
    np.testing.assert_array_equal(got[:, rv], want[:, rv])
    scale = np.maximum(np.abs(want).max(0), 1e-30)
    d = np.abs(got - want)
    np.testing.assert_array_less(np.delete(d / scale, S.DEPTH, axis=1)[:, :rv.start - 1],
                                 1e-4)
    assert d[:, S.DEPTH].max() <= 5e-5


@pytest.mark.parametrize("seed,special,near", [(0, False, 0.0), (1, True, 2.0)])
def test_preprocess_surfels_matches_jax(seed, special, near):
    args, W = _inputs(seed, special=special)
    jc, tc = JR(**RASTER, near=near), TR(**RASTER, near=near)
    want = np.asarray(js.preprocess_surfels(*args, W, jc))
    t_args = [torch.from_numpy(np.array(a)) for a in args]
    got = ts.preprocess_surfels(*t_args, W, tc).numpy()
    assert got.shape == want.shape == (args[0].shape[0], ts.SurfelCols.width(C))
    _compare_rows(got, want)
    valid = want[:, ts.SurfelCols.validf(C)] > 0
    assert valid.sum() > 100
    if special:
        assert not valid[[0, 1, 2, 3, 5]].any()


def test_preprocess_surfels_gradients_match_jax():
    """Autograd of the preprocess against jax.vjp, with a cotangent on every
    differentiable column (Tu, Tv, Tw, normal, opacity, depth, features,
    center), including the guarded rows."""
    import jax

    args, W = _inputs(2, special=True)
    jc, tc = JR(**RASTER), TR(**RASTER)
    S = ts.SurfelCols
    g = np.random.default_rng(5).normal(size=(args[0].shape[0], S.width(C))).astype(np.float32)
    g[:, S.rect(C).start:] = 0.0
    n_diff = 5                       # means, scales2, quats, opacities, feat

    def jfn(*diff):
        return js.preprocess_surfels(*diff, *args[n_diff:], W, jc)

    _, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args[:n_diff]])
    want = vjp(jnp.asarray(g))
    xs = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in args[:n_diff]]
    out = ts.preprocess_surfels(*xs, *[torch.from_numpy(np.array(a)) for a in args[n_diff:]],
                                W, tc)
    out.backward(torch.from_numpy(g))
    for name, x, w in zip(("means", "scales2", "quats", "opacities", "feat"), xs, want):
        w = np.asarray(w, np.float64)
        got = x.grad.numpy().astype(np.float64)
        assert np.isfinite(got).all(), name
        rel = np.linalg.norm(got - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= 1e-4, (name, rel)
        assert np.abs(w).max() > 0, name


def _render_both(seed, golden, raster=None, n=150, H=16, W=256):
    raster = dict(RASTER, **(raster or {}))
    args, W = _inputs(seed, n=n, H=H, W=W)
    jc, tc = JR(**raster), TR(**raster)
    pk = np.asarray(js.preprocess_surfels(*args, W, jc))
    bg = np.array([0.2, 0.6], np.float32)
    beams = args[-1]
    oj = js.render_surfels(jnp.asarray(pk), jnp.asarray(beams), W, jnp.asarray(bg), jc, C=C,
                           golden=golden)
    ot = ts.render_surfels(torch.from_numpy(np.array(pk)), torch.from_numpy(np.array(beams)), W,
                           torch.from_numpy(bg), tc, C=C, golden=golden)
    return oj, ot


OUTPUTS = [("color", 1e-5, 2e-2), ("final_T", 1e-5, 2e-2), ("occ", 1e-5, 2e-2),
           ("normal", 1e-5, 2e-2), ("depth", 5e-4, 2.0), ("median_depth", 5e-4, 2.0),
           ("distortion", 1e-6, 1e-3)]


@pytest.mark.parametrize("golden", [False, True])
def test_render_surfels_matches_jax(golden):
    oj, ot = _render_both(3, golden)
    for name, atol, flip in OUTPUTS:
        assert_close_up_to_flips(getattr(ot, name).numpy(), np.asarray(getattr(oj, name)),
                                 atol, flip, what=name)
    np.testing.assert_array_equal(ot.visible.numpy(), np.asarray(oj.visible))
    assert int(ot.n_overflow) == int(oj.n_overflow) == 0
    assert int(ot.n_dropped) == int(oj.n_dropped) == 0
    assert float(ot.occ.max()) > 0.5 and float(ot.median_depth.max()) > 0
    assert float(ot.distortion.max()) > 0


def test_tiled_matches_golden():
    """The port's tiled render (through SurfelCompositeTiles) against its own
    golden chunk scan over one whole-image list (same rule, other chunks)."""
    _, tiled = _render_both(4, False)
    _, gold = _render_both(4, True)
    for name, atol, flip in OUTPUTS:
        assert_close_up_to_flips(getattr(tiled, name).numpy(), getattr(gold, name).numpy(),
                                 atol, flip, what=name)


@pytest.mark.parametrize("raster", [
    dict(tile_capacity=8, max_tiles_per_gaussian=4),   # tiles overflow
    dict(max_visible=100),                             # the cull drops valid surfels
    dict(tile_h=4, tile_capacity=64),                  # 4x128 tiles
])
def test_binning_counters_equal_jax(raster):
    oj, ot = _render_both(5, False, raster)
    assert int(ot.n_overflow) == int(oj.n_overflow)
    assert int(ot.n_dropped) == int(oj.n_dropped)
    if raster.get("tile_capacity") == 8:
        assert int(oj.n_overflow) > 0
    if "max_visible" in raster:
        assert int(oj.n_dropped) > 0
    for name, atol, flip in OUTPUTS:
        assert_close_up_to_flips(getattr(ot, name).numpy(), np.asarray(getattr(oj, name)),
                                 atol, flip, what=name)
