"""The port's anchor field and render path against the JAX package, on the
JAX package's own parameters carried across by `params_from_jax`.

Decode tolerances: 1e-5 (f32 products summed in another order). End to
end, the two projections differ by XLA's and libm's atan2/exp ulps, which
can move a parity-rect bound by one pixel and so add or remove one instance
from a pixel: color and occupancy must agree to 1e-4 on all but 1% of the
elements (at most 1.0 anywhere), depth to 1e-3 m likewise (at most 80 m,
the far plane), and the counters within 1% + 2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidargs_tpu.config import ModelConfig as JM
from lidargs_tpu.config import RasterConfig as JR
from lidargs_tpu.lidar.frames import LidarFrame as JFrame
from lidargs_tpu.models import field as jf
from lidargs_tpu.utils.serialization import save_pytree_npz
from lidargs_torch.config import ModelConfig as TM
from lidargs_torch.config import RasterConfig as TR
from lidargs_torch.lidar import LidarFrame as TFrame
from lidargs_torch.lidar import uniform_beam_inclinations
from lidargs_torch.models import field as tf
from lidargs_torch.utils.params import load_params_npz, params_from_jax
from lidargs_torch.utils.testing import (assert_close_up_to_flips, one_torch_thread, sensor_poses,
                                         shell_anchors)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


N_ANCHORS, CAP = 400, 512
RASTER = dict(tile_h=4, tile_capacity=128, max_tiles_per_gaussian=8, max_visible=2048)


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else np.array(v)
            for k, v in tree.items()}


def _jax_field(seed=0, **mkw):
    """JAX params with the shell anchors in the first rows, plus random
    offsets, as a tree of numpy arrays."""
    mcfg = JM(anchor_capacity=CAP, **mkw)
    num_cameras = 3 if mcfg.appearance_dim else 0
    p = _numpy_tree(jf.init_field_params(jax.random.key(seed), mcfg, num_cameras))
    rows = shell_anchors(N_ANCHORS, mcfg.feat_dim, seed)
    for name, arr in rows.items():
        p[name][:N_ANCHORS] = arr
    rng = np.random.default_rng(seed + 1)
    p["offset"][:N_ANCHORS] = rng.normal(size=(N_ANCHORS, mcfg.n_offsets, 3)) * 0.5
    valid = np.arange(CAP) < N_ANCHORS
    return mcfg, p, valid


def _frames(H=16, W=256, seed=2):
    beams = uniform_beam_inclinations(2.4, 20.9, H)
    gt = np.zeros((3, H, W), np.float32)
    pose = sensor_poses(1, seed)[0]
    return (JFrame.from_lidar2world(pose, beams, gt, uid=1),
            TFrame.from_lidar2world(pose, beams, gt, uid=1, device="cpu"))


@pytest.mark.parametrize("mkw", [
    {},                                                   # fused-head branch
    dict(appearance_dim=4, use_feat_bank=True),           # per-head branch
    dict(add_cov_dist=False),                             # per-head, no cov dist
])
def test_decode_matches_jax(mkw):
    mcfg, p, valid = _jax_field(**mkw)
    tp = params_from_jax(p, device="cpu")
    rng = np.random.default_rng(5)
    vis = rng.uniform(size=CAP) > 0.3
    center = np.asarray([1.0, -2.0, 0.5], np.float32)
    uid = np.int32(1)
    j = jax.jit(lambda p, v, a: jf.generate_neural_gaussians(p, v, a, center, mcfg, uid))(
        p, valid, vis)
    t = tf.generate_neural_gaussians(tp, torch.from_numpy(valid), torch.from_numpy(vis),
                                     torch.from_numpy(center), TM(**{**mkw, "anchor_capacity": CAP}),
                                     cam_uid=torch.tensor(1))
    assert tuple(t.xyz.shape) == (CAP, mcfg.n_offsets, 3)
    for name in t._fields:
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5, err_msg=name)
    assert t.mask.sum() > N_ANCHORS


@pytest.mark.parametrize("cap", [0, 300])
def test_render_field_matches_jax(cap):
    mcfg, p, valid = _jax_field()
    jframe, tframe = _frames()
    jr_cfg = JR(**RASTER, visible_anchor_cap=cap)
    bg = np.asarray([0.1, 0.2], np.float32)
    jout, _, jvis = jax.jit(lambda p, v, f: jf.render_field(p, v, f, mcfg, jr_cfg, bg))(
        p, valid, jframe)
    tout, _, tvis = tf.render_field(params_from_jax(p, device="cpu"), torch.from_numpy(valid),
                                    tframe, TM(anchor_capacity=CAP),
                                    TR(**RASTER, visible_anchor_cap=cap), torch.from_numpy(bg))
    assert (tvis.numpy() != np.asarray(jvis)).sum() <= 2
    assert_close_up_to_flips(tout.color.numpy(), np.asarray(jout.color), 1e-4, 1.0, what="color")
    assert_close_up_to_flips(tout.occ.numpy(), np.asarray(jout.occ), 1e-4, 1.0, what="occ")
    assert_close_up_to_flips(tout.depth.numpy(), np.asarray(jout.depth), 1e-3, 80.0,
                             what="depth")
    assert float(tout.occ.mean()) > 0.01
    for name in ("n_overflow", "n_dropped"):
        a, b = int(getattr(tout, name)), int(getattr(jout, name))
        assert abs(a - b) <= 0.01 * max(a, b) + 2, (name, a, b)
    nv = int(tout.visible.sum())
    assert abs(nv - int(jout.visible.sum())) <= 0.01 * nv + 2
    if cap:
        assert int(tout.n_dropped) > 0       # visible anchors beyond the cap


def test_load_params_npz_matches_params_from_jax(tmp_path):
    mcfg, p, _ = _jax_field(appearance_dim=4)
    path = tmp_path / "params.npz"
    save_pytree_npz(str(path), jax.tree.map(jnp.asarray, p))
    a = load_params_npz(str(path), device="cpu")
    b = params_from_jax(p, device="cpu")

    def walk(x, y, path=""):
        assert set(x) == set(y), path
        for k in x:
            if isinstance(x[k], dict):
                walk(x[k], y[k], f"{path}/{k}")
            else:
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k].numpy(), y[k].numpy(), err_msg=f"{path}/{k}")

    walk(a, b)
    assert "mlp_opacity" in a and set(a["mlp_opacity"]) == {"l1", "l2"}


@pytest.mark.parametrize("mkw", [{}, dict(appearance_dim=4, use_feat_bank=True)])
def test_init_field_params_layout_matches_jax(mkw):
    num_cameras = 3 if mkw else 0
    jp = _numpy_tree(jf.init_field_params(jax.random.key(0), JM(anchor_capacity=64, **mkw),
                                          num_cameras))
    mk = lambda s: tf.init_field_params(TM(anchor_capacity=64, **mkw), num_cameras,
                                        generator=torch.Generator().manual_seed(s),
                                        device="cpu")
    tp, tp_again = mk(0), mk(0)

    def walk(t, j, again, path=""):
        assert set(t) == set(j), path
        for k in t:
            if isinstance(t[k], dict):
                walk(t[k], j[k], again[k], f"{path}/{k}")
                continue
            assert tuple(t[k].shape) == j[k].shape and t[k].dtype == torch.float32, path + k
            np.testing.assert_array_equal(t[k].numpy(), again[k].numpy())
            if path.endswith(("/l1", "/l2")):       # U(-1/sqrt(d_in), 1/sqrt(d_in))
                lim = 1.0 / np.sqrt(t["w"].shape[0])
                assert float(t[k].abs().max()) <= lim
            elif not k.startswith("appearance"):    # deterministic rows: equal
                np.testing.assert_array_equal(t[k].numpy(), j[k])

    walk(tp, jp, tp_again)
