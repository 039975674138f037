"""The port's LPIPS (`lidargs_torch/train/lpips.py`) against the JAX
package's, on the CPU, with random parameters (no pretrained file can be
fetched): JAX's draws carried across, the converter's npz layout read by
both, and the port's own draws and writer read by JAX.

Tolerance: 1e-5 relative (float32 convolutions and sums in another order;
measured ~1e-6). The card against the CPU is the `cuda` case.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

from lidargs_tpu.train import lpips as jlp
from lidargs_torch.train import lpips as tlp
from lidargs_torch.utils.testing import one_torch_thread

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def jparams():
    return jlp.random_lpips_params(jax.random.key(0))


def _net(params):
    return tlp.lpips_net(jax.tree.map(np.asarray, params), "cpu")


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=shape).astype(np.float32) for _ in range(2))


def test_lpips_matches_jax(jparams):
    x, y = _pair(1, (2, 3, 32, 48))
    want = np.asarray(jax.jit(jlp.lpips)(jparams, x, y))
    net = _net(jparams)
    got = tlp.lpips(net, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.shape == (2,) and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert float(tlp.lpips(net, torch.from_numpy(x), torch.from_numpy(x))[0]) == 0.0


@pytest.mark.parametrize("shape", [(32, 48), (1, 32, 48), (3, 32, 48)])
def test_lpips_single_matches_jax(jparams, shape):
    a, b = _pair(2, shape)
    want = float(jax.jit(jlp.lpips_single)(jparams, a, b))
    got = tlp.lpips_single(_net(jparams), torch.from_numpy(a), torch.from_numpy(b))
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=RTOL)


def test_converter_npz_loads_in_both_packages(tmp_path):
    """`tools/convert_lpips_weights.py`'s extraction, from a torch module in
    torchvision's `.features` layout and an lpips v0.1 lin state dict, read
    by both packages' `load_lpips_params`."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from convert_lpips_weights import extract_lpips_arrays

    rnd = tlp.random_lpips_params(5)
    layers, ci, cin = [], 0, 3
    for v in tlp._VGG_CFG:
        if v == "M":
            layers.append(torch.nn.MaxPool2d(2, 2))
            continue
        conv = torch.nn.Conv2d(cin, v, 3, padding=1)
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(rnd["conv_w"][ci]))
            conv.bias.copy_(torch.from_numpy(rnd["conv_b"][ci]))
        layers += [conv, torch.nn.ReLU()]
        ci, cin = ci + 1, v
    lin_sd = {f"lin{i}.model.1.weight": torch.from_numpy(w) for i, w in enumerate(rnd["lin_w"])}
    path = str(tmp_path / "lpips_vgg.npz")
    np.savez(path, **extract_lpips_arrays(torch.nn.Sequential(*layers), lin_sd))

    x, y = _pair(3, (1, 3, 32, 48))
    want = np.asarray(jlp.lpips(jlp.load_lpips_params(path), x, y))
    loaded = tlp.load_lpips_params(path)
    for k in ("conv_w", "conv_b", "lin_w"):
        assert all(np.array_equal(a, b) for a, b in zip(loaded[k], rnd[k]))
    got = tlp.lpips(tlp.lpips_net(loaded, "cpu"), torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


def test_port_params_and_writer_load_in_jax(tmp_path):
    """`random_lpips_params` draws the shapes JAX's does; `save_lpips_params`
    writes the converter's layout, which JAX's loader reads."""
    params = tlp.random_lpips_params(0)
    jshapes = jax.tree.map(lambda a: a.shape, jlp.random_lpips_params(jax.random.key(0)))
    assert jax.tree.map(np.shape, params) == jshapes
    assert [w.shape[1] for w in params["lin_w"]] == list(tlp.LIN_CHANNELS)
    path = str(tmp_path / "w.npz")
    tlp.save_lpips_params(path, params)
    with np.load(path) as z:
        assert sorted(z.files) == sorted([f"conv{i}_{s}" for i in range(13) for s in "wb"]
                                         + [f"lin{i}_w" for i in range(5)])
    x, y = _pair(4, (1, 3, 16, 32))
    want = np.asarray(jlp.lpips(jlp.load_lpips_params(path), x, y))
    got = tlp.lpips(tlp.lpips_net(params, "cpu"), torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


def test_images_under_16_pixels_are_refused(jparams):
    """Four pools leave VGG's fifth block an empty map below 16 rows: JAX's
    mean over it is NaN; the port raises."""
    x, y = _pair(6, (1, 3, 8, 128))
    assert np.isnan(np.asarray(jlp.lpips(jparams, x, y))[0])
    with pytest.raises(ValueError, match="16x16"):
        tlp.lpips(_net(jparams), torch.from_numpy(x), torch.from_numpy(y))


@pytest.mark.cuda
def test_lpips_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    params = tlp.random_lpips_params(0)
    a, b = (torch.from_numpy(v) for v in _pair(7, (64, 512)))
    cpu = float(tlp.lpips_single(tlp.lpips_net(params, "cpu"), a, b))
    card = float(tlp.lpips_single(tlp.lpips_net(params, "cuda"), a.cuda(), b.cuda()))
    assert card == pytest.approx(cpu, rel=1e-4)
