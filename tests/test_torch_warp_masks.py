"""The forward kernels' per-warp row masks (`csrc/fwd_stage.cuh`): the plain
twin `composite_kernel.warp_row_mask` against each lane's own rect test, and
kernels K1, K3, K5 and K7 on the card on the masks' edge cases.

A warp of 32 pixels walks only the rows whose parity rect meets the box of
its pixel columns and rows (for surfels, only valid rows). That is safe iff
the mask holds every row on which some lane's rect test passes; where a
warp's pixels are consecutive columns of one pixel row, as in every tiling
of the port (tiles are 128 columns wide), it holds no other row. The inputs
are the JAX render path's (`_kernel_inputs`, `_surfel_inputs`), 8 x 200
pixels, with these edges written into every tile's list:
  * rect edges exactly on a warp boundary (a rect ending at the tile's
    column 32, one starting there, one ending past the tile's last column
    and row, one above the tile's first row);
  * the partial last tile column (W = 200: 72 of its 128 columns lie in the
    image, the rest past it; a rect running past the image's edge);
  * tile_h 1 and 4;
  * a count inside a chunk (at most 70 + t of 128 rows: rows past it in no
    mask);
  * invalid surfels (flag 0 on rows with a rect over the whole tile).

The `cuda` cases hold K1 and K5 on the same inputs against their plain
versions (the bounds of `test_torch_composite_kernel.py` and
`test_torch_surfel_kernel.py`), K3 == K1 and K7 == K5 bit for bit on windows
of one buffer holding the same rows, and two launches equal. Whether a card
is present is decided in a fixture: without one they skip.
"""
import functools

import numpy as np
import pytest
import torch

from lidargs_torch.config import RasterConfig as TCfg
from lidargs_torch.ops import composite_kernel as ck
from lidargs_torch.ops import surfel_kernel as sk
from lidargs_torch.ops.projection import PackedCols as PC
from lidargs_torch.ops.surfel import SurfelCols as S
from lidargs_torch.utils.testing import one_torch_thread
from test_torch_composite_bwd import _windows_of
from test_torch_composite_kernel import _compare, _kernel_inputs
from test_torch_surfel_kernel import _compare_out, _surfel_inputs


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


C = 2
K = 128
CASES = [("beam", 1), ("beam", 4), ("surfel", 1), ("surfel", 4)]


@functools.lru_cache(maxsize=None)
def _edge_inputs(variant, tile_h):
    """(inst, counts, pix, rect column, valid column or None, port config)
    of an 8 x 200 scene with the module docstring's edges (numpy; shared,
    so callers copy before writing)."""
    build, cols = (_surfel_inputs, S) if variant == "surfel" else (_kernel_inputs, PC)
    _, inst, counts, pix = build(0, 500, 8, 200, tile_capacity=K, tile_h=tile_h)
    inst, counts = inst.copy(), counts.copy()
    rc = cols.rect(C).start
    c0, r0 = pix[:, 3, :1], pix[:, 4, :1]                  # each tile's first column, row
    th = float(tile_h)
    edges = [[c0 + 16, c0 + 32, r0, r0 + 1],              # ends where warp 1's columns start
             [c0 + 32, c0 + 33, r0, r0 + th],             # starts there, one column wide
             [c0 + 95, c0 + 129, r0 + th - 1, r0 + th + 3],  # past the tile's last column, row
             [c0, c0 + 128, r0 - 2, r0],                  # above the tile's first row
             [c0 + 72, c0 + 300, r0, r0 + th]]            # past the image's right edge
    for k, e in enumerate(edges):
        inst[:, k, rc:rc + 4] = np.concatenate(e, -1)
    counts = np.minimum(counts, 70 + np.arange(len(counts))).astype(np.int32)
    assert (counts >= 10).all() and (counts > 64).sum() >= 4   # counts inside chunk 1
    valid = None
    if variant == "surfel":
        valid = S.validf(C)
        inst[:, 5:10, rc:rc + 4] = np.concatenate([c0 - 1, c0 + 129, r0 - 1, r0 + th + 1], -1)[
            :, None]
        inst[:, 5:10, valid] = 0.0
    cfg = TCfg(max_visible=512, max_tiles_per_gaussian=64, chunk=8, tile_capacity=K,
               tile_h=tile_h)
    return inst, counts, pix, rc, valid, cfg


def _lanes_pass(inst, counts, pix, rc, valid):
    """[T, K, n_warps]: some lane of the warp passes its rect test on the
    live (and valid) row, pixel by pixel."""
    T, Kr, _ = inst.shape
    npix = pix.shape[2]
    out = np.zeros((T, Kr, -(-npix // 32)), bool)
    for t in range(T):
        for k in range(int(counts[t])):
            r = inst[t, k]
            if valid is not None and not r[valid] > 0:
                continue
            for p in range(npix):
                px, py = pix[t, 3, p], pix[t, 4, p]
                if px >= r[rc] and px < r[rc + 1] and py >= r[rc + 2] and py < r[rc + 3]:
                    out[t, k, p // 32] = True
    return out


@pytest.mark.parametrize("variant,tile_h", CASES)
def test_warp_mask_holds_every_row_a_lane_passes(variant, tile_h):
    inst, counts, pix, rc, valid, _ = _edge_inputs(variant, tile_h)
    mask = ck.warp_row_mask(*(torch.from_numpy(x) for x in (inst, counts, pix)), rc,
                            valid).numpy()
    want = _lanes_pass(inst, counts, pix, rc, valid)
    assert mask.shape == want.shape == (len(counts), K, 4 * tile_h)
    assert not (want & ~mask).any()                  # no lane's row is dropped
    np.testing.assert_array_equal(mask, want)        # a warp's pixels fill its box
    k = np.arange(K)[None, :, None]
    assert not (mask & (k >= counts[:, None, None])).any()
    assert mask[:, :70].any() and not mask[:, 70 + len(counts):].any()
    # the edges, in every tile: warp w holds columns 32 (w % 4) .. + 32 of
    # pixel row w // 4
    np.testing.assert_array_equal(mask[:, 0, 0], True)
    np.testing.assert_array_equal(mask[:, 0, 1:], False)
    np.testing.assert_array_equal(mask[:, 1, 1::4], True)
    assert not mask[:, 1, 0::4].any() and not mask[:, 1, 2::4].any()
    last = slice(4 * tile_h - 2, 4 * tile_h)
    np.testing.assert_array_equal(mask[:, 2, last], True)
    assert not mask[:, 2, :4 * tile_h - 2].any()
    assert not mask[:, 3].any()
    np.testing.assert_array_equal(mask[:, 4, 2::4], True)  # past the image's edge too
    if variant == "surfel":
        assert not mask[:, 5:10].any()               # invalid, over the whole tile


def test_rows_for_the_bulk_copy_are_checked():
    rows = torch.zeros(3, 8, 24)
    ck.check_rows_aligned(rows)
    ck.check_rows_aligned(torch.zeros(100, 96))
    with pytest.raises(ValueError, match="F % 4 == 0"):
        ck.check_rows_aligned(torch.zeros(3, 8, 22))
    with pytest.raises(ValueError, match="16-byte aligned"):
        ck.check_rows_aligned(torch.zeros(3 * 8 * 24 + 1)[1:].view(3, 8, 24))
    with pytest.raises(ValueError, match="shared memory"):
        ck.check_rows_aligned(torch.zeros(10, 100))


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided per test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant,tile_h", CASES)
def test_cuda_forward_kernels_on_mask_edges(card, variant, tile_h):
    """K1 (K5) against its plain version, twice with equal bits, and K3
    (K7) on windows of one buffer holding the same rows equal to it bit for
    bit."""
    inst, counts, pix, _, _, cfg = _edge_inputs(variant, tile_h)
    mod, tiles, wins = ((sk, sk.surfel_composite_tiles, sk.surfel_composite_windows)
                        if variant == "surfel" else
                        (ck, ck.composite_tiles, ck.composite_windows))
    ti, tc, tp = (torch.from_numpy(x).to(card) for x in (inst, counts, pix))
    buf, starts = _windows_of(ti, tc)
    before = (mod.launches, mod.windows_launches)
    out1 = tiles(ti, tc, tp, C, cfg)
    out2 = tiles(ti, tc, tp, C, cfg)
    outw = wins(buf, starts, tc, tp, C, cfg)
    torch.cuda.synchronize()
    assert (mod.launches, mod.windows_launches) == (before[0] + 2, before[1] + 1)
    assert torch.equal(out1, out2) and torch.equal(outw, out1)
    plain = (sk.surfel_composite_tiles_plain if variant == "surfel"
             else ck.composite_tiles_plain)(ti, tc, tp, C, cfg)
    (_compare_out if variant == "surfel" else _compare)(out1.cpu().numpy(),
                                                         plain.cpu().numpy())
