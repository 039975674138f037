"""A backward kernel's miss in `chip_smoke.py` leaves its inputs behind.

`check_dinst` holds K2 / K4 / K6 / K8 to their plain versions (K2_TOL,
K6_TOL). When one misses, it writes the backward's captured arguments,
the kernel's dinst and the worst element's column share to an npz
(`save_bwd_miss`) under the run's output directory, prints the path, and
fails. Here a small scene's K2 arguments (the JAX render path's instances,
counts and pixel blocks, K1's output and a cotangent) go through a miss on
the CPU; the file is read back and the plain backward on its arrays is
held to JAX's `_bwd_call` in interpret mode (the Pallas kernel body), by
the bound of `tests/test_torch_composite_bwd.py`, as one would examine a
miss from the card.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from lidargs_tpu.config import RasterConfig as JCfg
from lidargs_tpu.ops.pallas_composite import _bwd_call
from lidargs_torch.config import RasterConfig as TCfg
from lidargs_torch.ops import composite_kernel as ck
from lidargs_torch.utils.testing import one_torch_thread
from test_torch_composite_bwd import CASES, NV, _case, _compare_dinst

C = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


def test_a_k2_miss_leaves_its_inputs_for_the_pallas_body(tmp_path, monkeypatch, capsys):
    jcfg, tcfg, inst, counts, pix, res, g = _case(CASES[0])
    args = (*(torch.from_numpy(np.array(a)) for a in (inst, counts, pix, res, g)), C, tcfg)
    want = ck.composite_tiles_bwd_plain(*args)
    got = want.clone()
    t, k = map(int, np.argwhere(want[..., 0].numpy() != 0)[7])
    col = 3
    scale = float(want[..., col].abs().max())
    got[t, k, col] += 2e-3 * scale                  # 0.2% of the column: beyond K2_TOL's max
    monkeypatch.setenv("CHIP_SMOKE_OUT", str(tmp_path / "out"))
    with pytest.raises(SystemExit):
        chip_smoke.check_dinst("K2 (test miss)", got, want, NV, chip_smoke.K2_TOL, args)
    path = tmp_path / "out" / "miss_K2_test_miss.npz"
    assert f"the miss's inputs are in {path}" in capsys.readouterr().err

    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(str(arrays.pop("meta")))
    assert meta["arg5"] == C and TCfg(**meta["arg6"]) == tcfg
    assert tuple(arrays["worst_index"]) == (t, k, col)
    assert arrays["worst_share"] == pytest.approx(2e-3, rel=1e-3)
    np.testing.assert_array_equal(arrays["dinst"], got.numpy())
    for i, a in enumerate((inst, counts, pix, res, g)):
        np.testing.assert_array_equal(arrays[f"arg{i}"], a)

    # the saved inputs as a study would take them: the plain backward
    # against the Pallas kernel body in interpret mode
    saved = [arrays[f"arg{i}"] for i in range(5)]
    cfg = TCfg(**meta["arg6"])
    fields = {f.name for f in dataclasses.fields(JCfg)}
    jcfg2 = JCfg(**{k: v for k, v in meta["arg6"].items() if k in fields},
                 pallas_chunk=jcfg.pallas_chunk, backend="pallas")
    plain = ck.composite_tiles_bwd_plain(*(torch.from_numpy(a) for a in saved), C, cfg).numpy()
    body = np.asarray(jax.jit(lambda *a: _bwd_call(*a, C, jcfg2))(*saved))
    np.testing.assert_array_equal(plain, want.numpy())
    _compare_dinst(plain, body)


def test_a_check_within_tolerance_writes_nothing(tmp_path, monkeypatch):
    _, tcfg, inst, counts, pix, res, g = _case(CASES[2])
    args = (*(torch.from_numpy(np.array(a)) for a in (inst, counts, pix, res, g)), C, tcfg)
    want = ck.composite_tiles_bwd_plain(*args)
    monkeypatch.setenv("CHIP_SMOKE_OUT", str(tmp_path / "out"))
    err = chip_smoke.check_dinst("K2 (test)", want.clone(), want, NV, chip_smoke.K2_TOL, args)
    assert err["max"] == 0.0 and not (tmp_path / "out").exists()
