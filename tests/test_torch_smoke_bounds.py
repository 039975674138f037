"""The pair counts behind the kernels' bounds in `chip_smoke.py`, a
rehearsal of its whole run on the CPU, and the kernel A/B tool's command
line.

`walked_pairs` counts, with tensor ops over whole tiles, the pixel-instance
pairs that K1's sequential walk visits, split into applied pairs (K2's
backward chain runs on these alone), other pairs inside the parity rect,
and pairs outside it, the rows of the tiles' lists that some pixel
visits (the rows behind the kernels' byte counts), and the (tile, warp of
32 pixels, row) visits in which some lane applies the row (the row
reductions K2 runs). Here it is held to a walk written out pixel by pixel
and row by row in float32 numpy, on the instances, counts and pixel blocks
of the JAX render path, for a sample of pixels. `walked_surfel_pairs` does
the same for K5's walk over surfels (split at the valid flag and the rect
test), held to a pixel-by-pixel walk over the same per-pair alphas and pass
flags. The counts are integers and must be equal.

The rehearsal runs `chip_smoke.run` on the CPU at a tiny size, with the
card-only helpers stubbed and each kernel wrapper (the tile and the window
forms of both variants) replaced by its plain version that counts launches
as the wrapper does: every phase's control flow, launch count check and
comparison runs, and the last line is the contract's.
"""
import json
import re

import numpy as np
import pytest
import torch

import chip_smoke
from lidargs_torch.config import RasterConfig as TCfg
from lidargs_torch.ops import knn_kernel
from lidargs_torch.ops.projection import PackedCols as PC
from lidargs_torch.utils import cuda_build, kernel_ab
from lidargs_torch.ops.surfel import SurfelCols as S
from lidargs_torch.ops.surfel import pair_geometry
from lidargs_torch.utils.testing import one_torch_thread
from test_torch_composite_kernel import _kernel_inputs
from test_torch_surfel_kernel import _surfel_inputs


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


C = 2


def _masked(inst, counts, pix, walked, rc, vf=None):
    """(tile, warp, row) visits of the forward kernels' masked walk: for each
    warp and chunk of 64 rows that one of its lanes reaches (`walked`, the
    (tile, warp, row) visits), the chunk's live rows, valid where `vf` names
    the flag, whose rect meets the box of the warp's pixel columns and rows."""
    n = 0
    for t in range(inst.shape[0]):
        for w in range(-(-pix.shape[2] // 32)):
            x, y = pix[t, 3, 32 * w:32 * w + 32], pix[t, 4, 32 * w:32 * w + 32]
            for k in range(int(counts[t])):
                r = inst[t, k]
                if ((t, w, k - k % 64) in walked and r[rc] <= x.max() and r[rc + 1] > x.min()
                        and r[rc + 2] <= y.max() and r[rc + 3] > y.min()
                        and (vf is None or r[vf] > 0)):
                    n += 1
    return n


def _walk(inst, counts, pix, cfg):
    """(applied, other in rect, out of rect, rows some pixel visits,
    (tile, warp, row) visits some lane applies, visits, visits with a lane
    in the rect, visits of the masked walk) from a sequential walk."""
    rc = PC.rect(C).start
    n = [0] * 8
    reduced = set()                                 # (tile, warp, row) with an applied lane
    walked, in_rect = set(), set()                  # ... visited, visited inside the rect
    f32 = np.float32
    for t in range(inst.shape[0]):
        reach = 0                                   # rows [0, reach) visited by some pixel
        for p in range(pix.shape[2]):
            dirx, diry, dirz, px, py = pix[t, :5, p]
            T = f32(1.0)
            for k in range(int(counts[t])):
                r = inst[t, k]
                reach = max(reach, k + 1)
                walked.add((t, p // 32, k))
                if not (px >= r[rc] and px < r[rc + 1] and py >= r[rc + 2] and py < r[rc + 3]):
                    n[2] += 1
                    continue
                in_rect.add((t, p // 32, k))
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
                reduced.add((t, p // 32, k))
                T = T_next
        n[3] += reach
    n[4:7] = len(reduced), len(walked), len(in_rect)
    n[7] = _masked(inst, counts, pix, walked, rc)
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
    pix = np.ascontiguousarray(pix[:, :, ::3])                # 43 of each tile's pixels
    cfg = TCfg(**case)
    got = chip_smoke.walked_pairs(torch.from_numpy(inst), torch.from_numpy(counts),
                                  torch.from_numpy(pix), C, cfg)
    want = _walk(inst, counts, pix, cfg)
    assert got == want
    assert want[0] > 0 and want[1] > 0 and want[2] > 0 and 0 < want[3] <= counts.sum()
    assert 0 < want[4] < want[0]                    # the warps' lanes share rows
    # the mask keeps every row with a lane in the rect and drops others; a
    # warp walks its masked rows to the end of the chunk where its last lane stops
    assert want[4] <= want[6] <= want[7] and want[6] < want[5]


def _walk_surfels(inst, counts, pix, cfg):
    """(applied, other past the valid and rect tests, stopped by them, rows
    some pixel visits, (tile, warp, row) visits some lane applies) from a
    sequential walk; each pair's alpha and pass flag come from
    `pair_geometry`, the walk, its stop rule and the split are written
    out."""
    rc, vf = S.rect(C).start, S.validf(C)
    it, ip = torch.from_numpy(inst), torch.from_numpy(pix)
    d = lambda i: ip[:, i, None, :]
    g = pair_geometry(it, d(0), d(1), d(2), d(3), d(4), C, cfg)
    alpha, passed = g.alpha.numpy(), g.passed.numpy()
    f32 = np.float32
    n = [0] * 8
    reduced = set()                                 # (tile, warp, row) with an applied lane
    walked, cheap = set(), set()                    # ... visited, visited past the cheap tests
    for t in range(inst.shape[0]):
        reach = 0                                   # rows [0, reach) visited by some pixel
        for p in range(pix.shape[2]):
            px, py = pix[t, 3, p], pix[t, 4, p]
            T = f32(1.0)
            for k in range(int(counts[t])):
                r = inst[t, k]
                reach = max(reach, k + 1)
                walked.add((t, p // 32, k))
                if not (r[vf] > 0 and px >= r[rc] and px < r[rc + 1] and py >= r[rc + 2]
                        and py < r[rc + 3]):
                    n[2] += 1
                    continue
                cheap.add((t, p // 32, k))
                if not passed[t, k, p]:
                    n[1] += 1
                    continue
                T_next = T * (f32(1.0) - alpha[t, k, p])
                if T_next < f32(cfg.transmittance_min):
                    n[1] += 1                       # the crossing: visited, not applied
                    break
                n[0] += 1
                reduced.add((t, p // 32, k))
                T = T_next
        n[3] += reach
    n[4:7] = len(reduced), len(walked), len(cheap)
    n[7] = _masked(inst, counts, pix, walked, rc, vf)
    return tuple(n)


@pytest.mark.parametrize("case", [
    dict(seed=0, n=160, H=8, W=256, tile_capacity=64),
    # an opaque pile-up: most pixels cross the threshold and stop early
    dict(seed=1, n=300, H=8, W=128, tile_capacity=128, scale=(2.0, 4.0), opaque=True),
])
def test_walked_surfel_pairs_counts_the_sequential_walk(case):
    case = dict(case)
    seed, n, H, W = (case.pop(k) for k in ("seed", "n", "H", "W"))
    extra = {k: case.pop(k) for k in ("scale", "opaque") if k in case}
    _, inst, counts, pix = _surfel_inputs(seed, n, H, W, **extra, **case)
    pix = np.ascontiguousarray(pix[:, :, ::3])                # 43 of each tile's pixels
    cfg = TCfg(**case)
    got = chip_smoke.walked_surfel_pairs(torch.from_numpy(inst), torch.from_numpy(counts),
                                         torch.from_numpy(pix), C, cfg)
    want = _walk_surfels(inst, counts, pix, cfg)
    assert got == want
    assert want[0] > 0 and want[1] > 0 and want[2] > 0 and 0 < want[3] <= counts.sum()
    assert 0 < want[4] < want[0]                    # the warps' lanes share rows
    # the mask keeps every row with a lane in the rect and drops others; a
    # warp walks its masked rows to the end of the chunk where its last lane stops
    assert want[4] <= want[6] <= want[7] and want[6] < want[5]


@pytest.mark.parametrize("kernel,n_q,n_p,pairs,kk,n_bytes,ops", [
    # N1: both [N, 3] float32 sets and their bool masks read, [n_q] written;
    # 7 operations a valid pair (the Gram value's three multiplies and three
    # adds, one compare)
    ("N1", 1000, 800, 900 * 700, 1, 13 * 1800 + 4 * 1000, 7),
    # N2: both sets read, [n_q, kk] written
    ("N2", 500, 500, 500 * 500, 4, 12 * 1000 + 4 * 500 * 4, 7),
    # N3: one set read, [n] written; 9 operations a pair of distinct points
    # (three subtracts, three multiplies, two adds, one compare)
    ("N3", 300, 300, 300 * 299, 1, 16 * 300, 9),
])
def test_knn_bound_counts_pairs_operations_and_bytes(kernel, n_q, n_p, pairs, kk, n_bytes, ops):
    """The bound of N1-N3 in `chip_smoke.py`: the pairs times the operations
    a pair over the FP32 peak, beside each input byte read once and each
    output byte written once over the memory rate; the larger names it."""
    b = chip_smoke.knn_bound(kernel, n_q, n_p, pairs, kk)
    assert (b["pairs"], b["ops_per_pair"], b["bytes"], b["ops"]) == (pairs, ops, n_bytes,
                                                                    ops * pairs)
    assert b["ops_ms"] == pytest.approx(ops * pairs / chip_smoke.PEAK_FP32_OPS_PER_S * 1e3)
    assert b["bytes_ms"] == pytest.approx(n_bytes / chip_smoke.PEAK_BYTES_PER_S * 1e3)
    assert b["bound_ms"] == max(b["ops_ms"], b["bytes_ms"]) and b["bound_by"] == "operations"
    # a frame of the street evaluation: 169,600 points a side, ~2.9 ms a direction
    frame = chip_smoke.knn_bound("N1", 169_600, 169_600, 169_600 ** 2)
    assert 2.9 < frame["bound_ms"] < 3.1
    with pytest.raises(ValueError, match="unknown kernel"):
        chip_smoke.knn_bound("N4", 1, 1, 1)


def test_kernel_ab_needs_labelled_source_trees():
    with pytest.raises(SystemExit, match="LABEL=CSRC_DIR"):
        kernel_ab.main([])
    with pytest.raises(SystemExit, match="LABEL=CSRC_DIR"):
        kernel_ab.main(["out", "lidargs_torch/csrc"])
    with pytest.raises(SystemExit, match="LABEL=CSRC_DIR"):          # a source of KERNELS only
        kernel_ab.main(["out", "knn3", "new=lidargs_torch/csrc"])


@pytest.mark.parametrize("name", sorted(kernel_ab.KERNELS))
def test_kernel_ab_binds_exported_launch_functions(name):
    """Each launch function `KERNELS` names is an `extern "C"` function of
    its source, with the tensor pointers, ints and float constants `_bind`
    declares for it (a text check: the sources build only on the card)."""
    src = (cuda_build.CSRC / f"{name}.cu").read_text()
    exported = src[src.index('extern "C" {'):]
    for symbol, n_ptr, n_int, n_float in kernel_ab.KERNELS[name]:
        m = re.search(rf"\bint {symbol}\(([^)]*)\)\s*{{", exported)
        assert m, f"{symbol} is not an extern \"C\" function of {name}.cu"
        params = [" ".join(p.split()) for p in m.group(1).split(",")]
        assert [p.split()[0] for p in params[n_ptr:n_ptr + n_int]] == ["int"] * n_int
        assert len(params) == n_ptr + n_int + n_float + 1 and params[-1] == "void* stream"
        assert all("*" in p for p in params[:n_ptr])
        assert all(p.split()[0] == "float" for p in params[n_ptr + n_int:-1])
    if name == "knn":
        assert kernel_ab.knn_interface(cuda_build.CSRC / "knn.cu") is kernel_ab.KERNELS["knn"]


def test_kernel_ab_knn_binds_the_first_design_and_its_plans(tmp_path):
    """A `knn.cu` whose N1 takes the point rows and their norms (the first
    design) is bound by `KNN_ROWS`; the plans with another cluster size
    keep the package's rows and cover the same points."""
    old = tmp_path / "knn.cu"
    old.write_text('extern "C" {\nint lidargs_knn_chamfer(const float* a, const float* a2, '
                   'const uint8_t* a_valid,\n const float* b, const float* b2, float* out, '
                   'int na, int nb, void* stream) {}\n}')
    assert kernel_ab.knn_interface(old) is kernel_ab.KNN_ROWS
    assert [s[1:] for s in kernel_ab.KNN_ROWS] == [(6, 2, 0), (5, 3, 0)]
    base = knn_kernel.launch_plan(160_899, 162_912, 132, 8)
    assert kernel_ab.knn_plan(160_899, 162_912, 132, 8, None) == base
    for cluster in kernel_ab.KNN_CLUSTERS:
        plan = kernel_ab.knn_plan(160_899, 162_912, 132, 8, None, cluster)
        assert (plan.rows_per_thread, plan.row_blocks) == (base.rows_per_thread, base.row_blocks)
        assert plan.cluster == cluster
        assert 0 <= plan.packed_rows - 162_912 < plan.cluster * knn_kernel.GROUP


def test_kernel_ab_reads_resources_and_scales_columns():
    log = ("ptxas info    : Function properties for _ZN49_GLOBAL__N__1_20surfel_bwd_kernelILi2ELb1"
           "ELi128ELi4EEEvPKfPKiS4_S2_S2_S2_PfiiiN7lidargs12SurfelConstsE\n"
           "    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads\n"
           "ptxas info    : Used 96 registers, used 1 barriers\n")
    assert kernel_ab.resources(log) == {"2,1,128,4": [96, 12, 16]}
    knn_log = ("ptxas info    : Function properties for _ZN49_GLOBAL__N__1_11gram_kernelILi4ELi8E"
               "Lb0EEEvNS_8GramArgsE\n    0 bytes stack frame, 0 bytes spill stores, 0 bytes "
               "spill loads\nptxas info    : Used 90 registers, used 1 barriers\n"
               "ptxas info    : Function properties for _ZN38_GLOBAL__N__25e71a40_6_knn_cu_"
               "aa1a685211knn3_kernelEPKfPfi\n"
               "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
               "ptxas info    : Used 40 registers, used 1 barriers\n")
    assert kernel_ab.resources(knn_log) == {"4,8,0": [90, 0, 0], "knn3_kernel": [40, 0, 0]}
    want = torch.zeros(3, 4, 8)
    want[..., :5] = torch.randn(3, 4, 5, generator=torch.Generator().manual_seed(0))
    assert kernel_ab.column_scaled(want.clone(), want, 5)["within_tol"]
    moved = want.clone()
    moved[0, 0, 1] += 1e-2 * want[..., 1].abs().max()       # 1% of the column's scale
    err = kernel_ab.column_scaled(moved, want, 5)
    assert not err["within_tol"] and err["far_count"] == 1
    moved = want.clone()
    moved[0, 0, 6] = 1.0                                    # a column past the gradients
    assert not kernel_ab.column_scaled(moved, want, 5)["within_tol"]


def test_kernel_ab_judges_every_bit():
    """A build whose output differs from the first build's by one bit
    fails, forward or backward; a backward one is also compared column by
    column."""
    gen = torch.Generator().manual_seed(0)
    fwd = torch.randn(4, 8, 32, generator=gen)
    bwd = torch.zeros(4, 16, 24)
    bwd[..., :16] = torch.randn(4, 16, 16, generator=gen)

    def flip(x):                                    # the lowest bit of the first element
        y = x.clone()
        y.view(-1).view(torch.int32)[0] ^= 1
        return y

    outs = {("old", "composite_fwd"): fwd, ("old", "composite_bwd"): bwd,
            ("new", "composite_fwd"): fwd.clone(), ("new", "composite_bwd"): bwd.clone()}
    nvs = {"composite_bwd": 16}
    same, failed = kernel_ab.judge(outs, nvs)
    assert failed == [] and same["new.composite_fwd"]["bit_equal"]
    assert "column_scaled" not in same["new.composite_fwd"]
    outs[("new", "composite_bwd")] = flip(bwd)
    same, failed = kernel_ab.judge(outs, nvs)
    assert failed == ["new.composite_bwd"] and not same["new.composite_bwd"]["bit_equal"]
    assert same["new.composite_bwd"]["column_scaled"]["within_tol"]
    outs[("new", "composite_fwd")] = flip(fwd)
    assert kernel_ab.judge(outs, nvs)[1] == ["new.composite_fwd", "new.composite_bwd"]
    outs[("old", "composite_fwd")] = outs[("new", "composite_fwd")]     # the first build rules
    assert kernel_ab.judge(outs, nvs)[1] == ["new.composite_bwd"]


def test_smoke_run_rehearses_on_the_cpu(monkeypatch, capsys):
    sizes = dict(H=16, W=256, N_ANCHORS=300, N_FRAMES=3, WARMUP=1, N_STEPS=2, TRAIN_TIMED=2,
                 MODEL=dict(anchor_capacity=512, feat_dim=8, n_offsets=2, mlp_hidden=8),
                 RASTER=dict(tile_h=4, tile_capacity=64, max_tiles_per_gaussian=8,
                             max_visible=2048),
                 SURFEL_RASTER=dict(tile_h=1, tile_capacity=64, max_tiles_per_gaussian=32,
                                    max_visible=2048),
                 OPT=dict(start_stat=0, update_from=0, update_interval=2, update_until=10 ** 6),
                 # the CLI phases: a 16x128 street (LPIPS needs 16 rows) of 50
                 # frames (the dynamic reader's scene size), of which the CLI
                 # reads the first 12 (11 train, test frame 0), a field of at
                 # most 4,096 anchors; 2 refiner epochs
                 CLI_SCENE=dict(n_frames=50, H=16, W=128, seed=0), CLI_NUM_FRAMES=12,
                 REFINE_EPOCHS=2, REFINE_TIMED=1,
                 CLI_VOXEL="1.0",
                 CLI_EXTRA=["--anchor_capacity", "4096", "--max_visible", "4096",
                            "--tile_capacity", "64"],
                 CLI_ITERS=4, CLI_SURFEL_ITERS=2, CLI_LOG_EVERY=2, CLI_PROFILE_STEPS=1,
                 KNN_POINTS=3000,
                 # phases 27-30: two-rank gloo fleets on the CPU, short runs
                 SURFEL_DP_STEPS=1, DP_RATE_STEPS=1, RENDER_TIMED=2, CLI_DP_ITERS=2,
                 # phases 31-33: 3,000 init points, 6 masked steps a sub-scene
                 DYN_INIT_SAMPLES=3000, DYN_STEPS=6, DYN_TIMED=1,
                 DYN_VOXEL={"background": 1.0, "vehicle": 0.3},
                 DYN_CAPACITY={"background": 4096, "vehicle": 512},
                 DYN_MIN_ANCHORS={"background": 100, "vehicle": 5},
                 # phase 34: 4 steps of each kind (Trainer(graphed=True) runs the
                 # graphs' bookkeeping on the CPU), a 100-anchor vehicle-style field
                 GRAPH_STEPS={"beam": 4, "surfel": 4, "masked": 4}, GRAPH_TIMED=2,
                 GRAPH_VEHICLE=dict(anchors=100, capacity=256), GRAPH_CLI_CAPACITY=1024)
    for name, value in sizes.items():
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "card", lambda: "CPU rehearsal")
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, iters, warmup: [(fn(), 1.0)[1]])
    monkeypatch.setattr(chip_smoke, "time_cold_ms", lambda fn, iters=20: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "profile_render",
                        lambda fn, frames=3: {"frames": frames, "device_ms_per_frame": "n/a"})
    monkeypatch.setattr(cuda_build, "build", lambda names, csrc=None: {})
    monkeypatch.setattr(chip_smoke, "sync_checked", lambda fn, label: fn())
    monkeypatch.setattr(chip_smoke, "pool_bytes", lambda pool: "not measured")
    monkeypatch.setattr(knn_kernel, "card_plan_inputs", lambda index, kk: (132, 8))
    # four CLI steps leave the ray-drop channel untrained, so a test frame's
    # render can be empty and its chamfer distance inf (the reference's value
    # for an empty cloud): require the metrics, finite but for that
    strict_results = chip_smoke.cli_results

    def cli_results(out, split="test"):
        m = json.loads((out / "results.json").read_text())[split]
        assert not any(np.isnan(v) for v in m.values())
        return strict_results(out, split) if np.isfinite(m.get("depth_cd", 0.0)) else m
    monkeypatch.setattr(chip_smoke, "cli_results", cli_results)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")
    chip_smoke.count_plain_launches(monkeypatch.setattr)
    chip_smoke.run(torch.device("cpu"))
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["ok"] is True and lines[-2] == "CPU rehearsal"
    kernels = json.loads(lines[-3])["kernels"]
    assert [k["name"] for k in kernels] == [
        "composite_fwd", "composite_bwd", "composite_fwd_windows", "composite_bwd_windows",
        "surfel_fwd", "surfel_bwd", "surfel_fwd_windows", "surfel_bwd_windows",
        "knn_chamfer", "knn_gram_topk", "knn3_direct"]
    assert [k["launches"] for k in kernels[:8]] == [3, 2] * 4
    assert all(k["source"] == "lidargs_torch/csrc/knn.cu" for k in kernels[8:])
    assert [k["replaces"] for k in kernels[8:]] == [
        "lidargs_tpu/ops/knn.py:60", "lidargs_tpu/ops/knn.py:22",
        "lidargs_tpu/native/lidargs_native.cpp:80"]
    timing = json.loads(lines[-4])["timing"]
    surfel = timing["surfel"]
    assert surfel["k5_launches_train"] == surfel["k6_launches"] == 2
    assert surfel["k5_bound"]["pairs_applied"] > 0
    for bound in (timing["train"]["k2_bound"], surfel["k6_bound"]):
        assert 0 < bound["warp_rows_reduced"] <= bound["pairs_applied"]
    assert timing["windows"]["train_launches"] == {"K1": 0, "K2": 0, "K3": 2, "K4": 2}
    assert timing["surfel_windows"]["render_launches"] == {"K5": 0, "K6": 0, "K7": 3, "K8": 0}
    # the forward kernels carry the warp walk's counts: the masked walk
    # keeps every visit with a lane in the rect and drops others
    for k in (kernels[0], kernels[2], kernels[4], kernels[6]):
        assert 0 < k["warp_row_visits_in_rect"] <= k["warp_row_visits_masked"]
        assert k["warp_row_visits_in_rect"] < k["warp_row_visits"]
    assert kernels[0]["warp_row_visits"] == timing["k1_bound"]["warp_row_visits"]
    # the window kernels' bounds count the same pairs as the tile kernels'
    assert timing["windows"]["K3_bound"]["pairs_applied"] == timing["k1_bound"]["pairs_applied"]
    assert (timing["surfel_windows"]["K7_bound"]["pairs_applied"]
            == surfel["k5_bound"]["pairs_applied"])
    # the CLI phases: every step launched each kernel once; the distance
    # code held against the k-d tree; finite chamfer metrics after the
    # resume and in the eval-only run
    cli = timing["cli"]
    assert cli["beam"]["steps"] == 4 and cli["resume"]["steps"] == 2
    assert cli["surfel"]["steps"] == 2 and cli["surfel"]["launches"]["K6"] == 2
    assert cli["beam"]["launches"]["K2"] == 4 and cli["beam"]["launches"]["K1"] > 4
    assert [k.get("launches_cli") for k in kernels] == [
        cli["beam"]["launches"]["K1"], 4, None, None, cli["surfel"]["launches"]["K5"], 2,
        None, None, None, None, None]
    assert cli["knn_oracle"]["points"] == 3000 and cli["knn_oracle"]["max_err_over_tol"] <= 1
    assert cli["chamfer_oracle"]["max_err_over_tol"] <= 1
    # N1-N3: two N1 launches a chamfer frame with both clouds (phase 20's two
    # sweeps of 12 frames, phase 22's one), one N2 launch at the init (the
    # anchors' scales at voxel 1.0), one in the oracle, one N3 launch in
    # phase 31; each held to its plain version and timed beside it
    n1, n2, n3 = kernels[8:]
    assert cli["beam"]["chamfer_frames"] == 24
    assert 0 < n1["launches"] == cli["beam"]["launches"]["N1"] <= 48 and n1["launches"] % 2 == 0
    assert 0 < n1["launches_eval_only"] == cli["eval_only"]["launches"]["N1"] <= 24
    assert n2["launches"] == cli["beam"]["launches"]["N2"] == 1 and n2["launches_oracle"] == 1
    assert n3["launches"] == 1 and n3["bit_equal"]
    for k in (n1, n2, n3):
        assert k["ms"] == k["plain_ms"] == 1.0 and k["bound_by"] == "operations"
        assert k["max_abs_err"] == 0.0 and k["bound_ms"] > 0
    assert n1["library_ms"] == n2["library_ms"] == 1.0 and n3["library_ms"] is None
    oracle = cli["chamfer_oracle"]
    assert n1["pairs"] == oracle["pred_points"] * oracle["gt_points"]
    assert oracle["vs_plain"]["launches_bit_equal"] and oracle["vs_plain"]["max_err_over_tol"] == 0
    assert n2["pairs"] == 3000 ** 2 and n3["pairs"] == 3000 * 2999
    # each entry carries its launch plan (132 SMs of 8 blocks stubbed) and
    # pairs a second
    assert n1["plan"]["merge"] == n2["plan"]["merge"] == "cluster"
    assert n2["plan"]["rows_per_thread"] == 4 and n2["plan"]["cluster"] == 2
    assert n1["plan"]["rows_per_thread"] == 8 and n1["plan"]["blocks_per_sm"] == 8
    assert n3["plan"] == chip_smoke.N3_PLAN
    assert all(k["pairs_per_s"] == k["pairs"] / 1e-3 for k in (n1, n2, n3))
    assert cli["knn_oracle"]["vs_plain"]["launches_bit_equal"]
    for run in (cli["beam"], cli["resume"], cli["eval_only"]):
        assert {"depth_cd", "depth_fscore"} <= set(run["test"])
        assert np.isfinite(run["test"]["intensity_psnr"])
    # phases 24-26: 12 frames dumped (K1 for each evaluated, timed and dumped
    # frame and the test frame's PNGs), both refiners trained 2 epochs of 11
    # steps, both evaluated with LPIPS
    refine = cli["refine"]
    assert refine["dump"] == {"s": refine["dump"]["s"], "files": 13, "k1_launches": 37}
    for arch in ("mlp", "unet"):
        r = refine["refine"][arch]
        assert r["steps"] == 22 and len(r["history"]) == 2
        assert r["history"][-1] < r["first_step_loss"]
        assert np.isfinite(refine["eval"][arch]["test"]["intensity_lpips"])
    assert refine["refine"]["unet_card_vs_cpu"]["out_max_abs"] == 0.0
    assert kernels[0]["launches_dump"] == 37
    assert refine["eval"]["mlp"]["k1_launches"] == refine["eval"]["unet"]["k1_launches"] == 25
    assert refine["eval"]["raydrop_acc_unrefined"] == cli["eval_only"]["test"]["raydrop_acc"]
    # phases 27-30: 4 K1 and K2 launches per one-process DP step, 2 per rank
    # and step in the fleet, one K1 launch per rank on half the tiles in the
    # sharded render, the CLI fleet's files
    dp = timing["dp"]
    assert dp["one_process"]["launches"] == {"K1": 8, "K2": 8}
    assert dp["one_process"]["surfel"]["launches"] == {"K5": 4, "K6": 4}
    assert dp["fleet"]["backend"] == "gloo" and len(set(map(tuple, dp["fleet"]["fingerprints"]))) == 1
    assert dp["fleet"]["collective_bytes_per_step"] > 0
    # the fleet sums the frames as the one-process witness does, to the bit
    assert dp["fleet"]["final_params_vs_witness"]["bit_equal"]
    assert dp["fleet"]["first_step_mu_vs_witness"]["bit_equal"]
    assert dp["one_process"]["witness_fleet_order"]["groups"] == [[0, 1], [2, 3]]
    assert min(dp["fleet"][f"{k}_ms_per_step_median"] for k in ("collective", "copy", "wait")) >= 0
    # the graphed step (its programs' bookkeeping on the CPU) against eager,
    # bit for bit: one process, both variants and statistics modes; each
    # rank of the fleet
    one = dp["one_process"]
    assert one["graphed"] and one["vs_eager"]["losses_equal"] and one["vs_eager"]["densify_equal"]
    for part in (one["vs_eager"]["final"], one["vs_eager"]["nostats_after_densify"],
                 one["surfel"]["final"], one["surfel"]["nostats"]):
        assert part["graph_vs_eager"]["bit_equal"]
    assert one["surfel"]["losses_equal"] and set(one["pool_bytes"]) == {
        "both_modes", "B1_capacity_512", "B2_capacity_512", "B4_capacity_512",
        "B4_capacity_1024"}
    assert dp["fleet"]["graphed"] == [True, True] and dp["fleet"]["eager_losses_equal"]
    assert all(g["bit_equal"] for g in dp["fleet"]["graphed_vs_eager"])
    assert dp["sharded"]["tiles_per_rank"] == 4 and dp["sharded"]["bit_equal"]
    assert dp["sharded"]["grad_launches"] == [[1, 1], [1, 1]]
    assert kernels[0]["launches_dp"] == 8 and kernels[0]["launches_sharded"] == 1
    assert kernels[1]["launches_dp"] == 8 and kernels[5]["launches_dp"] == 4
    cdp = cli["dp"]
    assert cdp["one_process"]["steps"] == 2 and cdp["fleet"]["steps"] == [2, 2]
    assert cdp["one_process"]["graphed"] is False      # the CLI's default on the CPU: eager
    assert cdp["fleet"]["launches_per_step"] == [1, 1] and cdp["fleet"]["snapshot_anchors"] > 0
    assert "outputs.p1.log" in cdp["fleet"]["files"]
    # phases 31-33: a background and a vehicle sub-scene of 46 + 4 frames,
    # 6 masked steps each (one K1 and K2 launch a step) and 4 test renders,
    # the exact 3-NN held to the k-d tree
    dyn = timing["dynamic"]
    assert dyn["bundle"]["frames"] == 50 and min(dyn["bundle"]["vehicle_pixels_per_frame"]) > 0
    assert dyn["knn3_oracle"]["points"] == 3000 and dyn["knn3_oracle"]["max_err_over_tol"] <= 1
    for name in ("background", "vehicle"):
        sub = dyn["subscenes"][name]
        assert (sub["train_frames"], sub["test_frames"]) == (46, 4)
        t = dyn["train"][name]
        assert t["launches"] == {"K1": 6, "K2": 6, "K1_test": 4}
        assert t["loss_last_mean"] < t["loss_first_mean"] and t["densify"] is not None
        assert all(a["pixels"] > 0 for a in t["test_after"])
    assert dyn["launches"] == {"K1": 20, "K2": 12}
    assert kernels[0]["launches_dynamic"] == 20 and kernels[1]["launches_dynamic"] == 12
    # phase 34: the static-buffer steps equal eager bit for bit, with a
    # densify and both statistics modes, one kernel pair a step; the renders
    graphs = timing["graphs"]
    for name, (fwd, bwd) in (("beam", ("K1", "K2")), ("surfel", ("K5", "K6")),
                             ("masked", ("K1", "K2"))):
        g = graphs[name]
        assert g["graph_vs_eager"]["bit_equal"] and g["losses_equal"] and g["render_bit_equal"]
        assert g["launches_graphed"][fwd] == g["launches_graphed"][bwd] == 4
        assert (g["densify_after"], g["stats_until"]) == (2, 3)
    assert graphs["masked"]["anchors"] == 100
