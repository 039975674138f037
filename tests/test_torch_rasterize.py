"""The port's tiled rasterizer against the JAX package's XLA-scan render and
against the golden O(P*HW) renderer, on the same Splats.

Both packages are fed JAX's projection output, so the binning integers
(`counts`, `ids`, `n_overflow`, `n_dropped`) must be exactly equal: an ulp
of difference in the projection could otherwise move a rect bound.
Images: atol 1e-5 on color and occupancy, 1e-4 on depth (metres), as the
JAX package's own kernel-vs-scan tests use, on all but at most 1% of the
elements: those are pixels whose walk stops one instance apart, where two
opaque instances put T * (1 - alpha) at the 1e-4 threshold and an ulp of
reassociation decides; they stay within 2e-2 (color, occupancy) and 2 m
(depth). See `assert_close_up_to_flips`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidargs_tpu.config import RasterConfig as JCfg
from lidargs_tpu.ops import projection as jp
from lidargs_tpu.ops import rasterize as jr
from lidargs_tpu.ops.composite import pixel_rays as j_pixel_rays
from lidargs_tpu.ops.reference import render_reference as j_reference
from lidargs_torch.config import RasterConfig as TCfg
from lidargs_torch.ops import rasterize as tr
from lidargs_torch.ops.composite import pixel_rays as t_pixel_rays
from lidargs_torch.ops.projection import PackedCols, Splats
from lidargs_torch.ops.reference import render_reference as t_reference
from lidargs_torch.utils.testing import assert_close_up_to_flips, make_scene, one_torch_thread


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


BASE = dict(max_visible=512, max_tiles_per_gaussian=64, tile_capacity=256, chunk=8)
BG = np.asarray([0.3, 0.7], np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _splats(seed, n=200, H=32, W=256, **kw):
    """JAX's Splats of a numpy scene, and the same arrays as a port Splats."""
    sc = make_scene(seed, n=n, H=H, W=W)
    cfg = JCfg(**{**BASE, **kw})
    jsp = jax.jit(lambda *a: jp.preprocess_gaussians(*a, sc.W, cfg))(
        sc.means3d, sc.scales, sc.quats, sc.opacities, sc.feat, sc.mask,
        sc.w2s_rot, sc.w2s_trans, sc.beams)
    return sc, jsp, Splats(*[_t(x) for x in jsp])


def _render_jax(jsp, sc, cfg):
    return jax.jit(lambda s: jr.render_tiled(s, jnp.asarray(sc.beams), sc.W, BG, cfg))(jsp)


FLIP_ATOL = {1e-5: 2e-2, 1e-4: 2.0}      # color/occupancy, depth


def _close(t_img, j_img, atol, what=""):
    assert_close_up_to_flips(np.asarray(t_img), np.asarray(j_img), atol, FLIP_ATOL[atol],
                             what=what)


@pytest.mark.parametrize("tile_h", [1, 4])
def test_render_tiled_matches_jax_and_golden(tile_h):
    kw = dict(tile_h=tile_h, tile_capacity=256 * tile_h)
    sc, jsp, tsp = _splats(2, **kw)
    j = _render_jax(jsp, sc, JCfg(**{**BASE, **kw}))
    tcfg = TCfg(**{**BASE, **kw})
    t = tr.render_tiled(tsp, _t(sc.beams), sc.W, _t(BG), tcfg)
    _close(t.color, j.color, 1e-5)
    _close(t.occ, j.occ, 1e-5)
    _close(t.depth, j.depth, 1e-4)
    assert int(t.n_overflow) == int(j.n_overflow) == 0
    assert int(t.n_dropped) == int(j.n_dropped) == 0
    np.testing.assert_array_equal(t.visible.numpy(), np.asarray(j.visible))
    assert float(t.occ.max()) > 0.5
    ref_c, ref_d, ref_o, _ = t_reference(tsp, _t(sc.beams), sc.W, _t(BG), tcfg)
    _close(t.color, ref_c, 1e-5, "color vs golden")
    _close(t.occ, ref_o, 1e-5, "occ vs golden")
    _close(t.depth, ref_d, 1e-4, "depth vs golden")


def test_render_reference_matches_jax():
    sc, jsp, tsp = _splats(4, n=120, H=16, W=128)
    cfg = JCfg(**BASE)
    j = jax.jit(lambda s: j_reference(s, jnp.asarray(sc.beams), sc.W, BG, cfg))(jsp)
    t = t_reference(tsp, _t(sc.beams), sc.W, _t(BG), TCfg(**BASE))
    for a, b, atol in zip(t, j, (1e-5, 1e-4, 1e-5, 1e-5)):
        _close(a, b, atol)


def _bin_inputs(tsp, cfg, V, C=2):
    pkv, n_dropped = tr.cull_sorted_rows(tsp, cfg)
    assert pkv.shape[0] == V
    return (pkv[:, PackedCols.rect(C)].to(torch.int32), pkv[:, PackedCols.center(C)],
            pkv[:, PackedCols.validf(C)] > 0.0, pkv, n_dropped)


def _jax_bin_inputs(jsp, cfg, C=2):
    P = jsp.valid.shape[0]
    V = min(cfg.max_visible, P)
    pk = jp.pack_splats(jsp)
    _, sel = jax.lax.sort((jsp.depth, jnp.arange(P, dtype=jnp.int32)), num_keys=1,
                          is_stable=True)
    pkv = jr.permutation_rows(pk, sel, V)
    return (pkv[:, PackedCols.rect(C)].astype(jnp.int32), pkv[:, PackedCols.center(C)],
            pkv[:, PackedCols.validf(C)] > 0.0, pkv)


@pytest.mark.parametrize("tile_h,cap,budget", [
    (1, 64, 0),           # dense grid
    (4, 8, 0),            # dense grid, the render default's rect cap
    (1, 64, 300 * 64),    # rank search, budget covers every instance
    (2, 16, 1500),        # rank search, starved budget (farthest dropped)
])
def test_binning_integers_equal_jax(tile_h, cap, budget):
    kw = dict(tile_h=tile_h, max_tiles_per_gaussian=cap, instance_capacity=budget,
              max_visible=256, tile_capacity=16)
    sc, jsp, tsp = _splats(3, n=300, **kw)
    jcfg, tcfg = JCfg(**{**BASE, **kw}), TCfg(**{**BASE, **kw})
    H = sc.beams.shape[0]
    gy, gx = tcfg.grid_shape(H, sc.W)
    rect, center, valid, pkv, n_dropped = _bin_inputs(tsp, tcfg, 256)
    jrect, jcenter, jvalid, jpkv = _jax_bin_inputs(jsp, jcfg)
    np.testing.assert_array_equal(pkv.numpy(), np.asarray(jpkv))
    assert int(n_dropped) == int(jsp.valid.sum()) - int(jvalid.sum()) > 0
    ids, counts, ovf = tr.bin_instances(rect, center, valid, tcfg, gx, gy)
    jids, jcounts, jovf = jax.jit(
        lambda r, c, v: jr.bin_instances(r, c, v, jcfg, gx, gy))(jrect, jcenter, jvalid)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert int(ovf) == int(jovf) > 0
    live = np.arange(tcfg.tile_capacity)[None, :] < counts.numpy()[:, None]
    np.testing.assert_array_equal(np.where(live, ids.numpy(), -1),
                                  np.where(live, np.asarray(jids), -1))
    # the render on the same Splats counts the same drops and overflow
    t = tr.render_tiled(tsp, _t(sc.beams), sc.W, _t(BG), tcfg)
    j = _render_jax(jsp, sc, jcfg)
    assert int(t.n_overflow) == int(j.n_overflow)
    assert int(t.n_dropped) == int(j.n_dropped)
    _close(t.color, j.color, 1e-5)
    _close(t.depth, j.depth, 1e-4)


def test_forced_overflow_matches_jax():
    kw = dict(tile_capacity=4, max_tiles_per_gaussian=16)
    sc, jsp, tsp = _splats(7, n=300, H=8, W=128, **kw)
    j = _render_jax(jsp, sc, JCfg(**{**BASE, **kw}))
    t = tr.render_tiled(tsp, _t(sc.beams), sc.W, _t(BG), TCfg(**{**BASE, **kw}))
    assert int(t.n_overflow) == int(j.n_overflow) > 0
    assert bool(torch.isfinite(t.color).all())
    _close(t.color, j.color, 1e-5)
    _close(t.occ, j.occ, 1e-5)
    _close(t.depth, j.depth, 1e-4)


def test_binning_key_overflow_raises():
    cfg = TCfg(tile_h=1)
    V, gx, gy = 2 ** 22, 2 ** 8, 2 ** 2
    z = torch.zeros((V,), dtype=torch.int32)
    with pytest.raises(ValueError, match="overflows int32"):
        tr._bin_sorted(torch.zeros((V, 4), dtype=torch.int32), torch.zeros((V, 2)),
                       z.bool(), cfg, gx, gy)


@pytest.mark.parametrize("tile_h", [1, 4])
def test_tile_pixels_and_rays_match_jax(tile_h):
    H, W = 13, 300            # ragged last tile row and column
    beams = make_scene(0, n=1, H=H, W=W).beams
    cfg_t, cfg_j = TCfg(tile_h=tile_h), JCfg(tile_h=tile_h)
    gy, gx = cfg_t.grid_shape(H, W)
    tx, ty, td = tr._tile_pixels(H, W, cfg_t, gx, gy, _t(beams))
    jx, jy, jd = jr._tile_pixels(H, W, cfg_j, gx, gy, jnp.asarray(beams))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_allclose(tr._pix_blocks(tx, ty, td).numpy(),
                               np.asarray(jr._pix_blocks(jx, jy, jd)), atol=1e-6)
    rows = np.arange(H, dtype=np.int32).repeat(W)
    cols = np.tile(np.arange(W, dtype=np.int32), H)
    np.testing.assert_allclose(t_pixel_rays(_t(rows), _t(cols), _t(beams), W).numpy(),
                               np.asarray(j_pixel_rays(rows, cols, jnp.asarray(beams), W)), atol=1e-6)
