"""The pair counts behind the kernels' bounds in `chip_smoke.py`, and the
kernel A/B tool's command line.

`walked_pairs` counts, with tensor ops over whole tiles, the pixel-instance
pairs that K1's sequential walk visits, split into applied pairs (K2's
backward chain runs on these alone), other pairs inside the parity rect,
and pairs outside it. Here it is held to a walk written out pixel by pixel
and row by row in float32 numpy, on the instances, counts and pixel blocks
of the JAX render path, for a sample of pixels. The counts are integers
and must be equal.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from lidargs_torch.config import RasterConfig as TCfg
from lidargs_torch.ops.projection import PackedCols as PC
from lidargs_torch.utils import kernel_ab
from test_torch_composite_kernel import _kernel_inputs

C = 2


def _walk(inst, counts, pix, cfg):
    """(applied, other in rect, out of rect) from a sequential walk."""
    rc = PC.rect(C).start
    n = [0, 0, 0]
    f32 = np.float32
    for t in range(inst.shape[0]):
        for p in range(pix.shape[2]):
            dirx, diry, dirz, px, py = pix[t, :5, p]
            T = f32(1.0)
            for k in range(int(counts[t])):
                r = inst[t, k]
                if not (px >= r[rc] and px < r[rc + 1] and py >= r[rc + 2] and py < r[rc + 3]):
                    n[2] += 1
                    continue
                dx, dy, dz = r[0] - dirx, r[1] - diry, r[2] - dirz
                ddx = dx * r[3] + dy * r[4] + dz * r[5]
                ddy = dx * r[6] + dy * r[7] + dz * r[8]
                power = f32(-0.5) * (r[9] * ddx * ddx + r[11] * ddy * ddy) - r[10] * ddx * ddy
                alpha = min(r[PC.OPACITY] * np.exp(power), f32(cfg.alpha_clamp))
                if not (power <= 0.0 and alpha >= f32(cfg.alpha_min)):
                    n[1] += 1
                    continue
                T_next = T * (f32(1.0) - alpha)
                if T_next < f32(cfg.transmittance_min):
                    n[1] += 1                       # the crossing: visited, not applied
                    break
                n[0] += 1
                T = T_next
    return tuple(n)


@pytest.mark.parametrize("case", [
    dict(seed=0, n=200, H=16, W=256, tile_capacity=64),
    # opaque pile-up: most pixels cross the threshold and stop early
    dict(seed=1, n=400, H=16, W=128, tile_capacity=128, scale_px=8.0),
])
def test_walked_pairs_counts_the_sequential_walk(case):
    case = dict(case)
    seed, n, H, W = (case.pop(k) for k in ("seed", "n", "H", "W"))
    scale_px = case.pop("scale_px", 2.0)
    _, inst, counts, pix = _kernel_inputs(seed, n, H, W, scale_px, **case)
    pix = np.ascontiguousarray(pix[:, :, ::23])               # a sample of each tile's pixels
    cfg = TCfg(**case)
    got = chip_smoke.walked_pairs(torch.from_numpy(inst), torch.from_numpy(counts),
                                  torch.from_numpy(pix), C, cfg)
    want = _walk(inst, counts, pix, cfg)
    assert got == want
    assert want[0] > 0 and want[1] > 0 and want[2] > 0


def test_kernel_ab_needs_labelled_source_trees():
    with pytest.raises(SystemExit, match="LABEL=CSRC_DIR"):
        kernel_ab.main([])
    with pytest.raises(SystemExit, match="LABEL=CSRC_DIR"):
        kernel_ab.main(["out", "lidargs_torch/csrc"])
