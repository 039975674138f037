"""The port's training CLI (`lidargs_torch/train/cli.py`) against the JAX
package's, on the 8x128, 50-frame fixture of `tests/test_data_cli.py`, and
the helpers it uses (`utils/debug.py`, `profiling.py`, `visualize.py`).

One JAX CLI run (8 iterations, a checkpoint at 4, a snapshot at 8) serves
the module. Tolerances: the port's eval of JAX's snapshot gives JAX's
`results.json` to 1e-4 relative in the intensity and depth metrics (and
`intensity_lpips`) and 1e-3 relative in `depth_cd` (the chamfer sums run
in float32 in another order), the F-score within 1e-3 and the counts equal;
everything else (configs, frame schedules, file names, checkpoint keys) is
equal. The ray-drop refiner's `refine` subcommand of each package writes a
file the other loads.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lidargs_tpu.models import raydrop as jr
from lidargs_tpu.train import cli as jcli
from lidargs_tpu.train import trainer as jtrainer
from lidargs_tpu.utils.serialization import load_pytree_npz, save_pytree_npz
from lidargs_torch.models import raydrop as tr
from lidargs_torch.train import cli
from lidargs_torch.train import lpips as tlp
from lidargs_torch.train import trainer as ttrainer
from lidargs_torch.utils.testing import one_torch_thread
from test_data_cli import _make_dataset

ROOT = Path(__file__).resolve().parents[1]
BASE = ["--voxel_size", "8.0", "--anchor_capacity", "2048", "--max_visible", "4096",
        "--tile_capacity", "64", "--log_every", "4"]
PALLAS_ONLY = {"pallas_chunk", "pallas_tiles_per_block", "backend"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


def _record_frames(monkeypatch, trainer_cls):
    """The uid of every frame `trainer_cls.step` is given, in order."""
    uids = []
    step = trainer_cls.step

    def recording(self, state, frame, iteration):
        uids.append(int(frame.uid))
        return step(self, state, frame, iteration)

    monkeypatch.setattr(trainer_cls, "step", recording)
    return uids


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's CLI: 8 iterations, checkpoint at 4, snapshot and eval (with
    the chamfer metrics) at 8; its frame order recorded."""
    tmp = tmp_path_factory.mktemp("cli")
    data = tmp / "data"
    _make_dataset(str(data))
    out = tmp / "jax"
    with pytest.MonkeyPatch.context() as mp:
        uids = _record_frames(mp, jtrainer.Trainer)
        jcli.main(["-s", str(data), "-m", str(out), *BASE, "--iterations", "8",
                   "--test_iterations", "--save_iterations", "8",
                   "--checkpoint_iterations", "4", "--eval_chamfer"])
    return {"data": data, "out": out, "uids": uids, "tmp": tmp,
            "results": json.loads((out / "results.json").read_text()),
            "per_view": json.loads((out / "per_view.json").read_text())}


def _files(root: Path) -> set:
    return {str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()}


def _assert_results_match(got: dict, want: dict):
    """The port's `results.json` against JAX's, within the module's
    tolerances."""
    assert set(got) == set(want) == {"test", "train"}
    for split in want:
        assert set(got[split]) == set(want[split])
        for k, w in want[split].items():
            g = got[split][k]
            if k == "depth_cd":
                assert g == pytest.approx(w, rel=1e-3), (split, k)
            elif k == "depth_fscore":
                assert g == pytest.approx(w, abs=1e-3), (split, k)
            else:
                assert g == pytest.approx(w, rel=1e-4, abs=1e-9), (split, k)


def test_port_evaluates_a_jax_snapshot_as_jax_does(jax_run):
    out = jax_run["tmp"] / "port_eval"
    shutil.copytree(jax_run["out"], out)
    cli.main(["-s", str(jax_run["data"]), "-m", str(out), *BASE, "--load_iteration", "8",
              "--eval_chamfer", "--device", "cpu"])
    got = json.loads((out / "results.json").read_text())
    _assert_results_match(got, jax_run["results"])
    assert {"depth_cd", "depth_fscore", "visible_count"} <= set(got["test"])
    per_view = json.loads((out / "per_view.json").read_text())
    assert {s: set(v) for s, v in per_view.items()} == \
        {s: set(v) for s, v in jax_run["per_view"].items()}
    assert sorted(os.listdir(out / "test_renders")) == sorted(
        f"{i:03d}_{n}.png" for i in range(4) for n in ("intensity", "depth", "gt_intensity"))


def test_port_evaluates_the_best_snapshot_of_a_jax_run(tmp_path):
    """`--load_iteration best` loads `point_cloud/iteration_best`, the best
    test-PSNR snapshot of a JAX CLI run (whose own parser refuses the
    value), and evaluates it as JAX's final evaluation of the same
    parameters (the run's one test iteration is its last)."""
    data = tmp_path / "data"
    _make_dataset(str(data))
    out = tmp_path / "jax"
    jcli.main(["-s", str(data), "-m", str(out), *BASE, "--iterations", "2",
               "--test_iterations", "2", "--save_iterations"])
    assert (out / "point_cloud" / "iteration_best" / "point_cloud.ply").exists()
    with pytest.raises(SystemExit):
        jcli.build_config(["-s", str(data), "--load_iteration", "best"])
    port = tmp_path / "port"
    shutil.copytree(out, port)
    cli.main(["-s", str(data), "-m", str(port), *BASE, "--load_iteration", "best",
              "--device", "cpu"])
    _assert_results_match(json.loads((port / "results.json").read_text()),
                          json.loads((out / "results.json").read_text()))
    assert cli.build_config(["-s", "/x", "--load_iteration", "7"])[1].load_iteration == 7
    with pytest.raises(SystemExit):
        cli.build_config(["-s", "/x", "--load_iteration", "last"])


def test_port_resumes_a_jax_checkpoint(jax_run, monkeypatch):
    """The port continues JAX's run from its checkpoint, and JAX reads the
    checkpoint the port writes."""
    import jax

    from lidargs_tpu.utils.serialization import load_pytree_npz

    out = jax_run["tmp"] / "port_resume"
    shutil.copytree(jax_run["out"], out)
    uids = _record_frames(monkeypatch, ttrainer.Trainer)
    state = cli.main(["-s", str(jax_run["data"]), "-m", str(out), *BASE, "--iterations", "8",
                      "--start_checkpoint", "4", "--checkpoint_iterations", "6",
                      "--test_iterations", "--save_iterations", "--device", "cpu"])
    assert len(uids) == 4 and int(state.step) == 8
    assert "resumed from iteration 4" in (out / "outputs.log").read_text()
    with np.load(out / "chkpnt4.npz") as a, np.load(out / "chkpnt6.npz") as b:
        assert set(a.files) == set(b.files)
        like = jax.tree.map(np.zeros_like, load_pytree_npz(str(out / "chkpnt4.npz"),
                                                           _jax_state_like(a)))
    back = load_pytree_npz(str(out / "chkpnt6.npz"), like)
    assert int(back.step) == 6 and back.valid.dtype == np.bool_


def _jax_state_like(archive):
    """A JAX TrainState shaped like the arrays of a checkpoint archive."""
    from lidargs_tpu.train.optim import AdamState

    tree: dict = {}
    for key in archive.files:
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = archive[key]
    opt = tree.pop("opt")
    return jtrainer.TrainState(opt=AdamState(**opt), **tree)


def test_port_cli_trains_resumes_and_warms_up_as_jax(jax_run, monkeypatch):
    """The port's own path: train with a checkpoint, a snapshot and the
    dumps, resume, warm-up restart and `--config`: the files JAX's CLI
    writes, and JAX's frame order."""
    out = jax_run["tmp"] / "port_train"
    data = str(jax_run["data"])
    uids = _record_frames(monkeypatch, ttrainer.Trainer)
    state = cli.main(["-s", data, "-m", str(out), *BASE, "--iterations", "8",
                      "--test_iterations", "--save_iterations", "8",
                      "--checkpoint_iterations", "4", "--eval_chamfer", "--device", "cpu"])
    assert uids == jax_run["uids"] and len(set(uids)) == 8
    assert int(state.step) == 8 and state.params["anchor"].device.type == "cpu"
    assert _files(out) == _files(jax_run["out"])
    assert set(json.loads((out / "results.json").read_text())["test"]) == \
        set(jax_run["results"]["test"])
    saved = json.loads((out / "cfg_args.json").read_text())
    assert saved["device"] == "cpu" and saved["iterations"] == 8

    uids.clear()
    cli.main(["-s", data, "-m", str(out), *BASE, "--iterations", "8", "--start_checkpoint", "4",
              "--test_iterations", "8", "--save_iterations", "--dump_renders", "--tensorboard",
              "--device", "cpu"])
    assert len(uids) == 4
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(out / "tb"))
    renders = os.listdir(out / "renders")
    assert len(renders) == 51 and "dir.npy" in renders          # 46 train + 4 test + dirs
    dump = np.load(out / "renders" / "test_000.npy")
    assert dump.shape == (6, 8, 128) and dump.dtype == np.float32

    # --config: the saved arguments as defaults, with --warmup's restart
    cfg_path = out / "cfg_args.json"
    cfg_path.write_text(json.dumps({**saved, "iterations": 4, "checkpoint_iterations": [],
                                    "save_iterations": [4], "warmup": True,
                                    "model_path": str(out / "warm")}))
    uids.clear()
    state = cli.main(["-s", data, "--config", str(cfg_path)])
    assert len(uids) == 8 and int(state.step) == 4
    log = (out / "warm" / "outputs.log").read_text()
    assert "rebooting from the saved point cloud" in log


def _cfg_dict(cfg):
    d = dataclasses.asdict(cfg)
    for k in PALLAS_ONLY:
        d["raster"].pop(k, None)
    return d


@pytest.mark.parametrize("extra", [
    [], ["--surfel"], ["--fused_gather"], ["--surfel", "--fused_gather"],
    ["--data_label", "kitti", "--tile_h", "2", "--tile_capacity", "512",
     "--max_tiles_per_gaussian", "16", "--instance_capacity", "4096",
     "--remat_projection", "1", "--update_from", "50", "--update_until", "900",
     "--update_interval", "50", "--start_stat", "10", "--raydrop_lambda", "2.5",
     "--depth_min", "2", "--test_iterations", "5", "7", "--checkpoint_iterations", "3"],
])
def test_build_config_fills_jax_tree(extra):
    argv = ["-s", "/data", "-m", "/out", "--iterations", "3000", *extra]
    cfg, args = cli.build_config(argv)
    jcfg, jargs = jcli.build_config(argv)
    assert _cfg_dict(cfg) == _cfg_dict(jcfg)
    assert set(vars(jargs)) == set(vars(args)) - {"device"}
    assert args.device == "cuda"


def test_config_merge(tmp_path):
    cfgf = tmp_path / "cfg_args.json"
    cfgf.write_text(json.dumps({"iterations": 123, "voxel_size": 2.5, "data_label": "kitti",
                                "device": "cpu", "not_a_flag": 1}))
    cfg, args = cli.build_config(["-s", "/x", "--config", str(cfgf)])
    assert cfg.opt.iterations == 123 and cfg.model.voxel_size == 2.5
    assert cfg.opt.raydrop_lambda == 1.0 and args.device == "cpu"
    cfg2, _ = cli.build_config(["-s", "/x", "--config", str(cfgf), "--iterations", "7"])
    assert cfg2.opt.iterations == 7


@pytest.mark.parametrize("flags, msg", [
    (["--mp_local_devices", "2"], "no virtual devices"),
])
def test_unported_flags_are_refused(flags, msg):
    with pytest.raises(ValueError, match=msg):
        cli.build_config(["-s", "/x", *flags])
    cli.build_config(["-s", "/x", "--data_parallel", "1"])       # one device is the port's
    with pytest.raises(ValueError, match="pallas_chunk"):
        cli.build_config(["-s", "/x", "--pallas_chunk", "64"])


COORD = ["--coordinator", "127.0.0.1:1234"]


@pytest.mark.parametrize("flags, want", [
    # one process, a frame batch: the runtime of one rank on --device
    (["--data_parallel", "1", "--dp_batch", "4", "--device", "cpu"],
     dict(data_parallel=1, rt=(None, 1, 0, "cpu"))),
    (["--data_parallel", "1", "--dp_batch", "4", "--surfel"],
     dict(data_parallel=1, rt=(None, 1, 0, "cuda"))),
    # a fleet: every process on the data axis
    (["--num_processes", "2", "--process_id", "1", "--dp_batch", "2", *COORD],
     dict(data_parallel=2, rt=("127.0.0.1:1234", 2, 1, "cuda"))),
    (["--num_processes", "2", "--data_parallel", "2", "--mp_platform", "cpu", *COORD],
     dict(data_parallel=2, rt=("127.0.0.1:1234", 2, 0, "cpu"))),
    (["--mp_platform", "gpu"], dict(data_parallel=1, rt=(None, 1, 0, "gpu"))),
    (["--num_processes", "4", "--device", "cpu", *COORD],
     dict(data_parallel=4, rt=("127.0.0.1:1234", 4, 0, "cpu"))),
    # no data-parallel flag: no runtime
    ([], dict(data_parallel=1, rt=None)),
])
def test_parallel_flags_build_the_config(flags, want):
    cfg, args = cli.build_config(["-s", "/x", *flags])
    assert cfg.parallel.data_parallel == want["data_parallel"]
    rt = cli.runtime_config(args)
    got = None if rt is None else (rt.coordinator_address, rt.num_processes, rt.process_id,
                                   rt.platform)
    assert got == want["rt"]
    if rt is not None:
        assert rt.local_device_count is None


@pytest.mark.parametrize("flags, msg", [
    (["--data_parallel", "2"], "launch 2 processes"),
    (["--data_parallel", "3", "--num_processes", "2", *COORD], "launch 3 processes"),
    (["--data_parallel", "1", "--num_processes", "2", *COORD], "spans every process"),
    (["--num_processes", "2"], "needs --coordinator"),
    (["--num_processes", "2", "--process_id", "2", *COORD], "outside 0..1"),
    (["--num_processes", "2", "--dp_batch", "3", *COORD], "divisible"),
    (["--dp_batch", "4"], "--data_parallel 1 or --num_processes"),
])
def test_parallel_flags_refuse_a_layout_the_port_cannot_run(flags, msg):
    with pytest.raises(ValueError, match=msg):
        cli.build_config(["-s", "/x", *flags])


def test_refiner_and_lpips_flags_are_accepted():
    args = cli.build_config(["-s", "/x", "--raydrop_refiner", "r.npz",
                             "--lpips_weights", "w.npz"])[1]
    jargs = jcli.build_config(["-s", "/x", "--raydrop_refiner", "r.npz",
                               "--lpips_weights", "w.npz"])[1]
    assert (args.raydrop_refiner, args.lpips_weights) == \
        (jargs.raydrop_refiner, jargs.lpips_weights) == ("r.npz", "w.npz")


def _dumps(root: Path, n: int = 3, H: int = 16, W: int = 32) -> Path:
    """A `--dump_renders` directory: `n` train frames [6, H, W] (intensity,
    ray drop, depth, GT ray drop, GT intensity, GT depth) and `dir.npy`,
    drawn from a seed; GT rays drop beyond 40 m."""
    rng = np.random.default_rng(0)
    root.mkdir(parents=True)
    for i in range(n):
        depth = rng.uniform(5.0, 80.0, (H, W))
        gt = (depth < 40.0).astype(np.float64)
        frame = [rng.uniform(size=(H, W)), rng.uniform(size=(H, W)), depth, gt,
                 rng.uniform(size=(H, W)), depth * gt]
        np.save(root / f"train_{i:03d}.npy", np.stack(frame).astype(np.float32))
    dirs = rng.normal(size=(H * W, 3))
    np.save(root / "dir.npy", (dirs / np.linalg.norm(dirs, axis=1, keepdims=True))
            .astype(np.float32))
    return root


def test_refine_subcommand_runs(tmp_path):
    """`python -m lidargs_torch.train.cli refine` trains and saves the MLP."""
    renders = _dumps(tmp_path / "renders")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-m", "lidargs_torch.train.cli", "refine",
                        "--renders", str(renders), "--epochs", "1", "--device", "cpu"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "mlp refiner saved to" in r.stdout
    assert isinstance(tr.load_refiner(str(renders / "raydrop_refiner.npz"), "cpu"),
                      tr.RayDropMLP)


def _jax_refine(arch: str, params, frame: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """JAX's refined ray drop of one dumped frame (depth over 80 m)."""
    H, W = frame.shape[1:]
    if arch == "unet":
        return np.asarray(jax.jit(jr.refine_raydrop_unet)(params, frame[1], frame[0],
                                                          frame[2] / 80.0))
    refine = jax.jit(lambda d, i, z: jr.refine_raydrop(params, d, i, z))   # static degrees
    return np.asarray(refine(dirs.reshape(H, W, 3), frame[0], frame[2] / 80.0))


def _port_refine(model, frame: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    H, W = frame.shape[1:]
    color = torch.from_numpy(frame[:2].copy())                 # [intensity, ray drop]
    with torch.no_grad():
        out = tr.refine_color(model, color, torch.from_numpy(frame[2]), 80.0,
                              torch.from_numpy(dirs.reshape(H, W, 3)))
    return out[1].numpy()


@pytest.mark.parametrize("arch", ["mlp", "unet"])
def test_refine_crosses_packages(arch, tmp_path):
    """`refine` of each package on the same dumps (2 epochs): each package
    loads the other's file, and both compute the same refined ray drop from
    either file (to 1e-4)."""
    renders = _dumps(tmp_path / "renders")
    files = {"jax": tmp_path / "jax.npz", "port": tmp_path / "port.npz"}
    argv = ["--renders", str(renders), "--arch", arch, "--epochs", "2"]
    jcli.refine_main(argv + ["--out", str(files["jax"])])
    model, hist = cli.refine_main(argv + ["--out", str(files["port"]), "--device", "cpu"])
    assert len(hist) == 2 and np.isfinite(hist).all()
    with np.load(files["jax"]) as a, np.load(files["port"]) as b:
        assert set(a.files) == set(b.files)
        assert all(a[k].shape == b[k].shape for k in a.files)
    like = (jr.init_unet(jax.random.key(0)) if arch == "unet"
            else jr.init_raydrop_mlp(jax.random.key(0)))
    frame = np.load(renders / "train_001.npy")
    dirs = np.load(renders / "dir.npy")
    for f in files.values():
        want = _jax_refine(arch, load_pytree_npz(str(f), like), frame, dirs)
        got = _port_refine(tr.load_refiner(str(f), "cpu"), frame, dirs)
        np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(_port_refine(model, frame, dirs), got, atol=0)


@pytest.mark.parametrize("arch", ["mlp", "unet"])
def test_port_evaluates_with_a_jax_refiner_and_lpips_as_jax_does(jax_run, arch):
    """Eval-only of JAX's snapshot with a refiner written by JAX and a random
    LPIPS npz in the converter's layout, in both CLIs: the same
    `results.json`, `intensity_lpips` included. The frames are a 16-row copy
    of the fixture's dataset (12 frames): at 8 rows four max-pools leave
    VGG's fifth block an empty map (JAX's LPIPS is NaN there, the port's
    raises)."""
    tmp = jax_run["tmp"]
    data = tmp / "data16"
    if not data.exists():
        _make_dataset(str(data), n_frames=12, H=16)
    refiner = tmp / f"refiner_{arch}.npz"
    save_pytree_npz(str(refiner), jr.init_unet(jax.random.key(4)) if arch == "unet"
                    else jr.init_raydrop_mlp(jax.random.key(4)))
    lp = tmp / "lpips.npz"
    tlp.save_lpips_params(str(lp), tlp.random_lpips_params(0))
    results = {}
    for name, main, extra in (("jax", jcli.main, []), ("port", cli.main, ["--device", "cpu"])):
        out = tmp / f"{name}_refined_{arch}"
        shutil.copytree(jax_run["out"], out)
        main(["-s", str(data), "-m", str(out), *BASE, "--num_frames", "12",
              "--load_iteration", "8", "--raydrop_refiner", str(refiner),
              "--lpips_weights", str(lp), *extra])
        results[name] = json.loads((out / "results.json").read_text())
    _assert_results_match(results["port"], results["jax"])
    for split in ("test", "train"):
        assert np.isfinite(results["port"][split]["intensity_lpips"])


def test_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["-s", str(tmp_path), "-m", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.refine_main(["--renders", str(_dumps(tmp_path / "renders"))])


# --- the helpers the CLI uses ---

def test_render_snapshots_cross_packages(tmp_path):
    """`snapshot_if_nonfinite` dumps the render inputs in JAX's layout:
    JAX's loader reads the port's dump and the port's loader JAX's."""
    from lidargs_tpu.utils import debug as jdebug
    from lidargs_torch.lidar.frames import LidarFrame
    from lidargs_torch.utils import debug

    rng = np.random.default_rng(0)
    params = {"anchor": torch.from_numpy(rng.normal(size=(6, 3)).astype(np.float32)),
              "mlp_cov": {"l1": {"w": torch.ones(2, 3)}}}
    valid = torch.tensor([True] * 4 + [False] * 2)
    frame = LidarFrame.from_lidar2world(np.eye(4), np.linspace(-0.3, 0.1, 4),
                                        rng.uniform(size=(3, 4, 16)), uid=3, device="cpu")
    assert debug.snapshot_if_nonfinite(1.0, str(tmp_path), 5, params, valid, frame) is None
    path = debug.snapshot_if_nonfinite(float("nan"), str(tmp_path), 5, params, valid, frame)
    assert path == str(tmp_path / "debug" / "nonfinite_iter5.npz")
    jp, jv, jf, jextra = jdebug.load_render_snapshot(path)
    np.testing.assert_array_equal(jp["anchor"], params["anchor"].numpy())
    np.testing.assert_array_equal(jv, valid.numpy())
    np.testing.assert_array_equal(jf.gt_image, frame.gt_image.numpy())
    assert int(jextra["iteration"]) == 5 and jf.pixel_mask is None
    jdebug.dump_render_snapshot(str(tmp_path / "j.npz"), jp, jv, jf, extra=jextra)
    tp, tv, tf, textra = debug.load_render_snapshot(str(tmp_path / "j.npz"), device="cpu")
    assert torch.equal(tp["mlp_cov"]["l1"]["w"], params["mlp_cov"]["l1"]["w"])
    assert torch.equal(tv, valid) and torch.equal(tf.w2s_rot, frame.w2s_rot)
    assert int(tf.uid) == 3 and np.isnan(textra["loss"])


def test_profiling_and_visualize_helpers(tmp_path):
    from lidargs_tpu.utils import visualize as jvis
    from lidargs_torch.utils import profiling, visualize

    timer = profiling.StepTimer().start()
    for _ in range(4):
        timer.tick(torch.zeros(1))
    s = timer.stats(skip=1)
    assert s["mean_ms"] >= 0 and s["steps_per_s"] > 0 and len(timer.times_ms) == 4
    assert not profiling.TensorBoardLogger(None).active
    assert not profiling.WandbLogger(None).active
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]

    depth = np.random.default_rng(1).uniform(0, 90, (8, 16))
    np.testing.assert_array_equal(visualize.depth_to_rgb(depth), jvis.depth_to_rgb(depth))
    visualize.save_image(str(tmp_path / "t.png"), visualize.intensity_to_rgb(depth / 90))
    jvis.save_image(str(tmp_path / "j.png"), jvis.intensity_to_rgb(depth / 90))
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
