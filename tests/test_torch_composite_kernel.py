"""Kernel K1: the port's plain composite against the JAX package's Pallas
kernel body, and the CUDA kernel against the plain version.

On the CPU, `composite_tiles_pallas` runs the real kernel body in interpret
mode, so these tests hold `composite_tiles_plain` to the TPU kernel itself
on identical [T, K, F] / [T] / [T, 8, NPIX] inputs. Tolerances: atol 1e-5 on
the feature and transmittance rows, 1e-4 on the depth row (metres), as the
JAX package's kernel-vs-scan tests use, on all but at most 1% of elements:
pixels whose walk stops one instance apart at the 1e-4 transmittance
threshold stay within 2e-2 (and 2 m of depth); see `assert_close_up_to_flips`.
The kernel drops the scan's /|u|^2 (the packed u1, u2 are unit vectors),
which moves results by f32 rounding.

The CUDA case needs a card and nvcc; it is marked `cuda` and skips here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidargs_tpu.config import RasterConfig as JCfg
from lidargs_tpu.ops import projection as jp
from lidargs_tpu.ops import rasterize as jr
from lidargs_tpu.ops.pallas_composite import composite_tiles_pallas
from lidargs_torch.config import RasterConfig as TCfg
from lidargs_torch.ops import composite_kernel as ck
from lidargs_torch.ops import projection as tp
from lidargs_torch.utils.stage_split import counting
from lidargs_torch.utils.testing import assert_close_up_to_flips, make_scene, one_torch_thread


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


C = 2


def _kernel_inputs(seed, n, H, W, scale_px=2.0, **kw):
    """[T,K,F] instances, [T] counts and [T,8,NPIX] pixel blocks as the JAX
    render path builds them for its composite kernel (numpy)."""
    cfg = JCfg(max_visible=512, max_tiles_per_gaussian=64, chunk=8, pallas_chunk=8,
               backend="pallas", **kw)
    sc = make_scene(seed, n=n, H=H, W=W, scale_px=scale_px)
    beams = jnp.asarray(sc.beams)

    @jax.jit
    def build(m, s, q, o, f, mask, rot, trans):
        sp = jp.preprocess_gaussians(m, s, q, o, f, mask, rot, trans, beams, W, cfg)
        P = sp.valid.shape[0]
        pk = jp.pack_splats(sp)
        _, sel = jax.lax.sort((sp.depth, jnp.arange(P, dtype=jnp.int32)), num_keys=1,
                              is_stable=True)
        pkv = jr.permutation_rows(pk, sel, min(cfg.max_visible, P))
        gy, gx = cfg.grid_shape(H, W)
        ids, counts, _ = jr.bin_instances(
            pkv[:, tp.PackedCols.rect(C)].astype(jnp.int32),
            pkv[:, tp.PackedCols.center(C)], pkv[:, tp.PackedCols.validf(C)] > 0.0,
            cfg, gx, gy)
        K = cfg.tile_capacity
        inst = jnp.take(pkv, ids.reshape(-1), axis=0, mode="clip").reshape(gy * gx, K, -1)
        px, py, dirs = jr._tile_pixels(H, W, cfg, gx, gy, beams)
        return inst, counts, jr._pix_blocks(px, py, dirs)

    inst, counts, pix = build(sc.means3d, sc.scales, sc.quats, sc.opacities, sc.feat,
                              sc.mask, sc.w2s_rot, sc.w2s_trans)
    return cfg, np.array(inst), np.array(counts), np.array(pix)


def _compare(out, ref):
    rows = list(range(C)) + [C + 1]
    assert_close_up_to_flips(out[:, rows], ref[:, rows], 1e-5, 2e-2, what="features, T")
    assert_close_up_to_flips(out[:, C], ref[:, C], 1e-4, 2.0, what="depth")
    np.testing.assert_array_equal(out[:, C + 2:], 0.0)


@pytest.mark.parametrize("case", [
    dict(seed=0, n=200, H=16, W=256, tile_capacity=64),
    # opaque pile-up: saturates transmittance, so the kernel's early exit
    # fires while the plain scan runs every chunk
    dict(seed=1, n=400, H=16, W=128, tile_capacity=128, scale_px=8.0),
    dict(seed=2, n=150, H=8, W=128, tile_capacity=128, tile_h=4),
])
def test_plain_matches_pallas_kernel_body(case):
    case = dict(case)
    seed, n, H, W = (case.pop(k) for k in ("seed", "n", "H", "W"))
    scale_px = case.pop("scale_px", 2.0)
    jcfg, inst, counts, pix = _kernel_inputs(seed, n, H, W, scale_px, **case)
    ref = np.asarray(jax.jit(lambda a, b, c: composite_tiles_pallas(a, b, c, C, jcfg))(
        inst, counts, pix))
    tcfg = TCfg(max_visible=512, max_tiles_per_gaussian=64, chunk=8, **case)
    out = ck.composite_tiles_plain(torch.from_numpy(inst), torch.from_numpy(counts),
                                   torch.from_numpy(pix), C, tcfg).numpy()
    assert out.shape == ref.shape == pix.shape
    _compare(out, ref)
    T_final = ref[:, C + 1]
    assert T_final.min() < 0.05 and (counts > 0).any()
    if scale_px > 2.0:
        # the pile-up saturates: a pixel stops below T = 1e-4 / (1 - alpha)
        assert (T_final < 1e-2).mean() > 0.05


def test_wrapper_on_cpu_is_the_plain_version():
    _, inst, counts, pix = _kernel_inputs(0, 120, 8, 128, tile_capacity=64)
    args = [torch.from_numpy(x) for x in (inst, counts, pix)]
    cfg = TCfg(chunk=8, tile_capacity=64)
    with counting() as n:
        out = ck.composite_tiles(*args, C, cfg)
    assert not any(n.values())             # the CPU path launches nothing
    np.testing.assert_array_equal(out.numpy(),
                                  ck.composite_tiles_plain(*args, C, cfg).numpy())
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        ck.composite_tiles(*meta, C, cfg)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_card():
    """K1 against the plain version on the same CUDA tensors. The kernel
    multiplies T in sequence where the plain version takes a chunked
    cumprod, so a pixel at the 1e-4 threshold may stop one instance apart:
    mean |d| <= 1e-5 and max |d| <= 2e-2 on features and T, depth mean
    <= 1e-3 and max <= 2.0 (metres)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    _, inst, counts, pix = _kernel_inputs(1, 400, 16, 128, 8.0, tile_capacity=128)
    dev = torch.device("cuda")
    args = [torch.from_numpy(x).to(dev) for x in (inst, counts, pix)]
    cfg = TCfg(chunk=8, tile_capacity=128)
    with counting() as n:
        out = ck.composite_tiles(*args, C, cfg)
        torch.cuda.synchronize()
    assert n["K1"] == 1
    ref = ck.composite_tiles_plain(*args, C, cfg)
    d = (out - ref).abs()
    feat = d[:, [0, 1, 3]]
    assert float(feat.mean()) <= 1e-5 and float(feat.max()) <= 2e-2
    assert float(d[:, 2].mean()) <= 1e-3 and float(d[:, 2].max()) <= 2.0
    assert bool((out[:, 4:] == 0).all())
    with pytest.raises(TypeError, match="int32"):
        ck.composite_tiles(args[0], args[1].long(), args[2], C, cfg)
