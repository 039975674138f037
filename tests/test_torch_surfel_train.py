"""The surfel (2DGS) variant's training path in the port against the JAX
package: the regularizers, one frame's loss and parameter gradients (with
the distortion and normal-consistency terms gated on and off), a few
`Trainer.step`s, and the render entry points with `variant="surfel"`.

The state is the JAX package's own: `init_field_from_points` on a numpy
point cloud, carried across by `train_state_from_jax`. 16x256 range view,
feat 8, k = 2, hidden 8, tile_capacity 64. Tolerances, each with its reason:
  * the regularizers alone: 1e-5 relative (f32 sums in another order), their
    gradients 1e-4 relative norm;
  * one frame's loss terms: 1e-4 relative. On the CPU the JAX package
    composites through its XLA chunk scan and takes autodiff of it; the port
    runs the plain versions of K5 and K6. They share the chunked rule, and
    differ where a pixel's transmittance sits at the 1e-4 threshold or its
    T-before at the median's 0.5;
  * the parameter gradients: 2e-3 relative norm per leaf, and the proxy's
    (the densification signal) likewise. Measured: 2e-5 to 7e-4, the
    largest on the anchors, whose gradient also reaches the projected
    center (rho2d), where an atan2 ulp between XLA and libm can move a
    parity-rect bound by one pixel;
  * three steps: the total loss within 1e-3 relative per step; the
    accumulated proxy gradients within 1e-2 relative norm (see the test).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidargs_tpu.config import ModelConfig as JM
from lidargs_tpu.config import OptConfig as JO
from lidargs_tpu.config import RasterConfig as JR
from lidargs_tpu.lidar.frames import LidarFrame as JFrame
from lidargs_tpu.models.field import init_field_from_points
from lidargs_tpu.train import losses as jl
from lidargs_tpu.train import trainer as jt
from lidargs_torch.config import ModelConfig as TM
from lidargs_torch.config import OptConfig as TO
from lidargs_torch.config import RasterConfig as TR
from lidargs_torch.lidar import LidarFrame as TFrame
from lidargs_torch.lidar import uniform_beam_inclinations
from lidargs_torch.models.field import render_field_surfel
from lidargs_torch.train import losses as tl
from lidargs_torch.train import trainer as tt
from lidargs_torch.train.evaluate import measure_fps, run_eval
from lidargs_torch.utils.params import train_state_from_jax
from lidargs_torch.utils.testing import one_torch_thread, sensor_poses


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


H, W = 16, 256
MODEL = dict(feat_dim=8, n_offsets=2, mlp_hidden=8, anchor_capacity=1024)
RASTER = dict(max_visible=2048, max_tiles_per_gaussian=8, tile_capacity=64, chunk=8)
ON = dict(dist_from=0, normal_from=0)
OFF = dict(dist_from=10 ** 6, normal_from=10 ** 6)


def _relnorm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _jax_state():
    """A JAX TrainState from `init_field_from_points` on 400 points of a
    street-like shell (the JAX package's surfel training tests' scene), as
    numpy arrays of its own: a JAX step donates what it is given."""
    return jax.tree.map(np.copy, _jax_state_once())


@functools.lru_cache(maxsize=1)
def _jax_state_once():
    rng = np.random.default_rng(5)
    n = 400
    az = rng.uniform(-np.pi, np.pi, n)
    el = rng.uniform(np.radians(-15.0), np.radians(5.0), n)
    r = rng.uniform(5.0, 40.0, n)
    pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                    r * np.sin(el)], -1)
    field = init_field_from_points(jax.random.key(0), JM(**MODEL), pts, voxel_size=1.5)
    return jax.tree.map(np.asarray, jt.init_train_state(field, JM(**MODEL)))


def _frames(n=1, seed=3):
    """(JAX, port) frame pairs: sensor poses and a GT image with every ray
    returned, as the JAX package's surfel training tests draw it."""
    beams = uniform_beam_inclinations(5.0, 20.0, H)
    rng = np.random.default_rng(seed)
    out = []
    for pose in sensor_poses(n, seed):
        gt = np.zeros((3, H, W), np.float32)
        gt[0] = 1.0
        gt[1] = rng.uniform(0.2, 0.8, (H, W))
        gt[2] = rng.uniform(6.0, 35.0, (H, W))
        out.append((JFrame.from_lidar2world(pose, beams, gt, uid=0),
                    TFrame.from_lidar2world(pose, beams, gt, uid=0, device="cpu")))
    return out


def test_depth_normals_and_consistency_match_jax():
    rng = np.random.default_rng(0)
    beams = uniform_beam_inclinations(5.0, 20.0, H)
    depth = rng.uniform(5.0, 30.0, (H, W)).astype(np.float32)
    depth[3:5, 10:40] = 0.0                         # empty pixels: zero cross products
    normal = rng.normal(size=(3, H, W)).astype(np.float32)
    normal[:, 0, :8] = 0.0                          # zero rendered normals
    hit = (rng.uniform(size=(H, W)) > 0.2).astype(np.float32)
    nj = np.asarray(jl.depth_normals(jnp.asarray(depth), jnp.asarray(beams), W))
    nt = tl.depth_normals(torch.from_numpy(depth), torch.from_numpy(beams), W).numpy()
    # unit normals from the cross product of differences of ~30 m points:
    # where the cross product cancels, a component moves by ~1e-6
    np.testing.assert_allclose(nt, nj, rtol=1e-5, atol=1e-5)

    def jloss(d, nr):
        return jl.normal_consistency_loss(nr, d, jnp.asarray(beams), W, jnp.asarray(hit))

    lj, (gdj, gnj) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(depth),
                                                               jnp.asarray(normal))
    d = torch.from_numpy(depth).requires_grad_(True)
    nr = torch.from_numpy(normal).requires_grad_(True)
    lt = tl.normal_consistency_loss(nr, d, torch.from_numpy(beams), W, torch.from_numpy(hit))
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    for got, want in ((d.grad, gdj), (nr.grad, gnj)):
        assert bool(torch.isfinite(got).all())
        assert _relnorm(got.numpy(), want) <= 1e-4


@pytest.mark.parametrize("gate", [ON, OFF], ids=["gated_on", "gated_off"])
def test_frame_loss_and_gradients_match_jax(gate):
    js0 = _jax_state()
    jfr, tfr = _frames(1)[0]
    bg = np.zeros(2, np.float32)
    jm, jr, jo = JM(**MODEL), JR(**RASTER), JO(**gate)
    proxy = jnp.zeros((MODEL["anchor_capacity"], MODEL["n_offsets"], 3), jnp.float32)

    def jloss(params, prox):
        return jt.frame_loss(params, prox, js0.valid, js0.step, jfr, jnp.asarray(bg), jm, jr, jo,
                             variant="surfel")

    (jtot, (jout, _, _, jlt)), (jg, jpg) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jax.tree.map(jnp.asarray, js0.params), proxy)
    s = train_state_from_jax(js0, device="cpu")
    (tout, _, _, tlt), tg, tpg = tt.loss_and_grads(s, tfr, torch.from_numpy(bg), TM(**MODEL),
                                                   TR(**RASTER), TO(**gate), variant="surfel")
    for f in jlt._fields:
        np.testing.assert_allclose(float(getattr(tlt, f).detach()), float(getattr(jlt, f)),
                                   rtol=1e-4,
                                   atol=1e-9, err_msg=f)
    assert int(tout.n_overflow) == int(jout.n_overflow)
    assert int(tout.n_dropped) == int(jout.n_dropped)
    np.testing.assert_array_equal(tout.visible.numpy(), np.asarray(jout.visible))
    base = float(tlt.depth + tlt.intensity + tlt.raydrop + tlt.scale_reg + tlt.grad_x)
    if gate is ON:
        assert float(tlt.total) > base * (1 + 1e-6)  # the regularizers count
    else:
        np.testing.assert_allclose(float(tlt.total), base, rtol=1e-6)
    n_live = 0
    for (path, a), (_, b) in zip(_leaves(tg), _leaves(jax.tree.map(np.asarray, jg))):
        if np.abs(b).max() == 0:
            np.testing.assert_array_equal(a.numpy(), 0.0, err_msg=path)
            continue
        assert _relnorm(a.numpy(), b) <= 2e-3, (path, _relnorm(a.numpy(), b))
        n_live += 1
    assert n_live >= 8
    # the proxy's gradient (the densification signal) reaches the world means
    assert float(np.abs(np.asarray(jpg)).max()) > 0
    assert _relnorm(tpg.numpy(), np.asarray(jpg)) <= 2e-3


def test_trainer_steps_follow_jax():
    """Three steps of each package's surfel Trainer from the same state,
    statistics on."""
    opt = dict(ON, start_stat=0, update_from=0)
    bg = np.zeros(2, np.float32)
    jtr = jt.Trainer(mcfg=JM(**MODEL), ocfg=JO(**opt), rcfg=JR(**RASTER), bg=jnp.asarray(bg),
                     variant="surfel")
    ttr = tt.Trainer(mcfg=TM(**MODEL), ocfg=TO(**opt), rcfg=TR(**RASTER),
                     bg=torch.from_numpy(bg), variant="surfel")
    js_, ts_ = _jax_state(), train_state_from_jax(_jax_state(), device="cpu")
    lj, lt = [], []
    for it, (jfr, tfr) in enumerate(_frames(3, seed=4), start=1):
        s, m = jtr.step(jax.tree.map(jnp.asarray, js_), jfr, it)   # donates: fresh arrays
        js_ = jax.tree.map(np.asarray, s)
        lj.append(float(m.loss.total))
        ts_, m = ttr.step(ts_, tfr, it)
        lt.append(float(m.loss.total))
    np.testing.assert_allclose(lt, lj, rtol=1e-3)
    assert int(ts_.step) == 3 and float(ts_.anchor_demon.max()) == 3.0
    assert float(ts_.offset_grad_accum.sum()) > 0
    # after the first step the parameters differ where Adam took a sign step
    # on a gradient at the noise level (adam_eps = 1e-15), so the later
    # proxy gradients drift: 1e-2 relative norm (measured 4.7e-3)
    assert _relnorm(ts_.offset_grad_accum.numpy(), js_.offset_grad_accum) <= 1e-2
    np.testing.assert_array_equal(ts_.offset_denom.numpy(), js_.offset_denom)
    for _, x in _leaves(ts_.params):
        assert bool(torch.isfinite(x).all())


def test_render_entry_points_take_the_variant(tmp_path):
    """`Trainer.render`, `measure_fps` and `run_eval` with variant="surfel"
    render through `render_field_surfel`; an unknown variant is refused."""
    s = train_state_from_jax(_jax_state(), device="cpu")
    frames = [f[1] for f in _frames(3, seed=6)]
    mcfg, rcfg, bg = TM(**MODEL), TR(**RASTER), torch.zeros(2)
    want = render_field_surfel(s.params, s.valid, frames[0], mcfg, rcfg, bg)[0]
    tr = tt.Trainer(mcfg=mcfg, ocfg=TO(), rcfg=rcfg, bg=bg, variant="surfel")
    got = tr.render(s.params, s.valid, frames[0])
    np.testing.assert_array_equal(got.distortion.numpy(), want.distortion.numpy())
    res = measure_fps(s.params, s.valid, frames, mcfg, rcfg, bg, warmup=1, device="cpu",
                      variant="surfel")
    assert len(res.outputs) == 3 and res.fps > 0
    np.testing.assert_array_equal(res.outputs[0].color.numpy(), want.color.numpy())
    assert float(want.occ.mean()) > 0 and float(want.median_depth.max()) > 0
    ev = run_eval(s.params, s.valid, {"test": frames[:1]}, mcfg, rcfg, bg, str(tmp_path),
                  device="cpu", variant="surfel")
    assert np.isfinite(ev["test"]["depth_rmse"]) and (tmp_path / "results.json").exists()
    with pytest.raises(ValueError, match="variant"):
        measure_fps(s.params, s.valid, frames, mcfg, rcfg, bg, warmup=1, device="cpu",
                    variant="disk")
    with pytest.raises(ValueError, match="variant"):
        tt.frame_loss(s.params, None, s.valid, s.step, frames[0], bg, mcfg, rcfg, TO(),
                      variant="disk")
