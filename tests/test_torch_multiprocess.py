"""The port's multi-process runtime across real process boundaries: a fleet
of two CPU processes coupled by `torch.distributed` (gloo), started by the
port's launcher (`parallel/scaling.py` `launch_fleet`), the worker being
this file's `__main__`.

The fleet trains four data-parallel steps of four frames (two per rank,
from the shared `frame_schedule`) with a densify after the second, and
renders one frame with `render_field_sharded` over a 1x2 tile axis, with
the gradient of JAX's test loss (`tests/test_parallel.py`). The test holds
the coordinator's results against the same run in one process of the port
and the render against JAX's `render_field`, forward and gradient. A second
fleet runs the training CLI with `--num_processes 2 --mp_platform cpu` on
the dataset of `tests/test_data_cli.py`.

Tolerances, each with its reason:
  * fleet against one process: `valid` and the statistics' visit counts
    equal; the first step's reduced gradients 1e-6 relative norm per leaf
    and the final parameters atol 1e-5 (JAX's `test_multiprocess.py`
    bound): only the order of the gradient sum differs ((f0+f1)+(f2+f3)
    against ((f0+f1)+f2)+f3); against one process that sums in the fleet's
    order (`local_sums` of each half, added, `apply_sums`): the whole state
    equal bit for bit;
  * the sharded render against one process's `render_field` of the port:
    equal bit for bit on the CPU (the same rows, sort and tiles);
  * against JAX's `render_field`: color atol 1e-5, depth 1e-4 up to
    threshold flips, gradients atol 3e-5 / rtol 2e-3 (JAX's own bounds for
    its sharded render);
  * the CLI fleet against `--data_parallel 1 --dp_batch 2` in one process:
    the snapshot's anchors equal in number, parameters atol 1e-5.
"""
import os
import sys

import numpy as np
import pytest
import torch

WORKER = os.path.abspath(__file__)
STEPS, BATCH, DENSIFY_AT = 4, 4, 2
RENDER_H = 16
OPT = dict(start_stat=0, update_from=0, update_interval=2, densify_grad_threshold=1e-7)
RENDER_MODEL = dict(feat_dim=8, n_offsets=2, mlp_hidden=8, anchor_capacity=1024)
RENDER_RASTER = dict(max_visible=2048, max_tiles_per_gaussian=16, tile_capacity=64, chunk=8)


def _render_loss(out):
    return (out.color ** 2).mean() + 0.01 * out.depth.mean()


def _train(state, frames, cfgs, mesh, rt=None):
    """STEPS data-parallel steps of BATCH frames from the shared schedule
    (this rank's slice of each), a densify after DENSIFY_AT with draws from
    a CPU generator seeded 7: (state after the first step, final state,
    losses, densify counts)."""
    from lidargs_torch.lidar import stack_frames
    from lidargs_torch.models.densify import densify_step
    from lidargs_torch.parallel import frame_schedule, make_dp_trainer

    mcfg, rcfg, ocfg = cfgs
    step = make_dp_trainer(mesh, mcfg, rcfg, ocfg, torch.zeros(2))
    first, losses, dens = None, [], None
    for t in range(STEPS):
        idx = frame_schedule(0, t, BATCH, len(frames))
        loc = rt.local_indices(idx, mesh) if rt is not None else idx
        state, m = step(state, stack_frames([frames[i] for i in loc]))
        losses.append(float(m.loss.total))
        first = state if first is None else first
        if t + 1 == DENSIFY_AT:
            state, ds = densify_step(state, mcfg, ocfg, 4.0, check_interval=2,
                                     generator=torch.Generator().manual_seed(7))
            dens = (int(ds.n_grown), int(ds.n_pruned))
    return first, state, losses, dens


def _train_fleet_order(state, frames, cfgs):
    """`_train` in one process with each step's gradients summed as the
    fleet sums them: each half of the step's frames in turn (`local_sums`),
    then the two halves added (gloo's sum of two ranks), then `apply_sums`:
    (state after the first step, final state)."""
    from lidargs_torch.lidar import stack_frames
    from lidargs_torch.models.densify import densify_step
    from lidargs_torch.parallel import frame_schedule
    from lidargs_torch.parallel.shard import apply_sums, local_sums

    mcfg, rcfg, ocfg = cfgs
    first = None
    for t in range(STEPS):
        idx = frame_schedule(0, t, BATCH, len(frames))
        halves = [local_sums(state, stack_frames([frames[i] for i in part]), torch.zeros(2),
                             mcfg, rcfg, ocfg)
                  for part in (idx[:BATCH // 2], idx[BATCH // 2:])]
        state, _ = apply_sums(state, halves[0][0] + halves[1][0],
                              torch.maximum(halves[0][1], halves[1][1]), BATCH, ocfg)
        first = state if first is None else first
        if t + 1 == DENSIFY_AT:
            state, _ = densify_step(state, mcfg, ocfg, 4.0, check_interval=2,
                                    generator=torch.Generator().manual_seed(7))
    return first, state


def _sharded_render(inputs, mesh):
    """render_field_sharded over `mesh`'s tile axis and the gradient of JAX's
    test loss: (color, depth, gradients as numpy leaves by path)."""
    from lidargs_torch.parallel.sharded_render import render_field_sharded
    from lidargs_torch.train.optim import tree_leaves, tree_unflatten

    params, valid, frame, mcfg, rcfg, bg = inputs["render"]
    leaves = [p.detach().clone().requires_grad_(True) for p in tree_leaves(params)]
    out = render_field_sharded(tree_unflatten(params, leaves), valid, frame, mcfg, rcfg, bg,
                               mesh)
    grads = torch.autograd.grad(_render_loss(out), leaves, allow_unused=True)
    return out, [np.zeros(x.shape, np.float32) if g is None else g.numpy()
                 for g, x in zip(grads, leaves)]


def worker(argv) -> None:
    """One rank: join the fleet, train, render sharded; the coordinator
    saves its results to the inputs' `out` prefix."""
    import argparse

    from lidargs_torch.parallel.runtime import RuntimeConfig, init_runtime, shutdown_runtime

    p = argparse.ArgumentParser()
    p.add_argument("inputs")
    p.add_argument("--num_processes", type=int)
    p.add_argument("--process_id", type=int)
    p.add_argument("--coordinator")
    a = p.parse_args(argv)
    torch.set_num_threads(1)
    rt = init_runtime(RuntimeConfig(coordinator_address=a.coordinator,
                                    num_processes=a.num_processes, process_id=a.process_id,
                                    platform="cpu"))
    inputs = torch.load(a.inputs, weights_only=False)
    mesh = rt.global_mesh()
    state0 = rt.replicate_tree(inputs["state"])
    prints = rt.fingerprint(state0)
    first, final, losses, dens = _train(state0, inputs["frames"], inputs["cfgs"], mesh, rt)
    out, grads = _sharded_render(inputs, rt.global_mesh(data=1, tile=2))
    rt.sync("done")
    if rt.is_coordinator:
        torch.save({"first": first, "final": final, "losses": losses, "densify": dens,
                    "fingerprints": prints, "backend": rt.backend,
                    "color": out.color.detach(), "depth": out.depth.detach(),
                    "n_overflow": int(out.n_overflow), "visible": out.visible,
                    "grads": grads}, inputs["out"])
    rt.sync("saved")
    shutdown_runtime()


if __name__ == "__main__":
    worker(sys.argv[1:])
    sys.exit(0)


import jax  # noqa: E402  (the worker above imports neither package's tests)
import jax.numpy as jnp  # noqa: E402

from lidargs_torch.config import ModelConfig as TM  # noqa: E402
from lidargs_torch.config import OptConfig as TO  # noqa: E402
from lidargs_torch.config import RasterConfig as TR  # noqa: E402
from lidargs_torch.parallel import make_mesh  # noqa: E402
from lidargs_torch.parallel.scaling import launch_fleet  # noqa: E402
from lidargs_torch.train.optim import tree_leaves  # noqa: E402
from lidargs_torch.utils.params import train_state_from_jax  # noqa: E402
from lidargs_torch.utils.testing import assert_close_up_to_flips, one_torch_thread  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


def _relnorm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _render_setup():
    """JAX's `test_sharded_render_matches_single_device` scene: a JAX field
    from 900 points at voxel 2, a 16x256 frame, bg (0.1, 0.9)."""
    from lidargs_tpu.lidar.frames import LidarFrame as JFrame
    from lidargs_tpu.models.field import init_field_from_points
    from lidargs_torch.lidar import LidarFrame, uniform_beam_inclinations
    from lidargs_torch.utils.params import params_from_jax

    rng = np.random.default_rng(0)
    az, el, r = rng.uniform(-np.pi, np.pi, 900), rng.uniform(-0.3, 0.1, 900), \
        rng.uniform(5.0, 50.0, 900)
    pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                    r * np.sin(el)], -1)
    beams = uniform_beam_inclinations(6.0, 24.0, RENDER_H)
    gt = np.zeros((3, RENDER_H, 256), np.float32)
    field = init_field_from_points(jax.random.key(0), _jm(RENDER_MODEL), pts, voxel_size=2.0)
    jparams = jax.tree.map(np.asarray, field.params)
    port = (params_from_jax(jparams, "cpu"), torch.from_numpy(np.array(field.valid)),
            LidarFrame.from_lidar2world(np.eye(4), beams, gt, uid=0, device="cpu"),
            TM(**RENDER_MODEL), TR(**RENDER_RASTER), torch.tensor([0.1, 0.9]))
    jax_side = (jparams, np.asarray(field.valid), JFrame.from_lidar2world(np.eye(4), beams, gt,
                                                                          uid=0))
    return port, jax_side


def _jm(kw):
    from lidargs_tpu.config import ModelConfig

    return ModelConfig(**kw)


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """The two-rank fleet's coordinator results, the inputs, and the same
    training in one process."""
    import test_torch_parallel as tp

    tmp = tmp_path_factory.mktemp("fleet")
    _, tfs = tp._frames(4)
    state0 = train_state_from_jax(tp._jax_state(), device="cpu")
    cfgs = (TM(**tp.MODEL), TR(**tp.RASTER), TO(**OPT))
    port_render, jax_render = _render_setup()
    inputs = {"state": state0, "frames": tfs, "cfgs": cfgs, "render": port_render,
              "out": str(tmp / "coordinator.pt")}
    torch.save(inputs, tmp / "inputs.pt")
    launch_fleet([sys.executable, WORKER, str(tmp / "inputs.pt")], 2, tmp / "logs",
                 timeout=300, env={"OMP_NUM_THREADS": "1"})
    res = torch.load(tmp / "coordinator.pt", weights_only=False)
    single = _train(state0, tfs, cfgs, make_mesh())
    return res, single, inputs, jax_render


def test_fleet_ranks_agree_and_use_gloo(fleet):
    res = fleet[0]
    assert res["backend"] == "gloo"
    assert len(res["fingerprints"]) == 2 and len(set(res["fingerprints"])) == 1


def test_fleet_training_matches_one_process(fleet):
    res, (first, final, losses, dens), _, _ = fleet
    assert res["densify"] == dens and sum(dens) > 0
    np.testing.assert_allclose(res["losses"], losses, rtol=1e-6)
    for a, b in zip(tree_leaves(res["first"].opt.mu), tree_leaves(first.opt.mu)):
        assert _relnorm(a.numpy(), b.numpy()) <= 1e-6
    assert torch.equal(res["final"].valid, final.valid)
    assert torch.equal(res["final"].anchor_demon, final.anchor_demon)
    assert torch.equal(res["final"].offset_denom, final.offset_denom)
    for a, b in zip(tree_leaves(res["final"].params), tree_leaves(final.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)
    assert int(res["final"].step) == STEPS


def test_fleet_training_equals_one_process_in_the_fleets_order(fleet):
    res, _, inputs, _ = fleet
    first, final = _train_fleet_order(inputs["state"], inputs["frames"], inputs["cfgs"])
    for a, b in zip(tree_leaves(res["first"].opt.mu), tree_leaves(first.opt.mu)):
        assert torch.equal(a, b)
    fa, fb = res["final"], final
    for a, b in zip(tree_leaves(fa.params) + tree_leaves(fa.opt.mu) + tree_leaves(fa.opt.nu)
                    + list(fa[2:]), tree_leaves(fb.params) + tree_leaves(fb.opt.mu)
                    + tree_leaves(fb.opt.nu) + list(fb[2:])):
        assert torch.equal(a, b)


def test_fleet_sharded_render_matches_one_process_and_jax(fleet):
    from lidargs_tpu.models.field import render_field as jrender
    from lidargs_torch.models.field import render_field

    res, _, inputs, (jparams, jvalid, jframe) = fleet
    params, valid, frame, mcfg, rcfg, bg = inputs["render"]
    with torch.no_grad():
        ref = render_field(params, valid, frame, mcfg, rcfg, bg)[0]
    assert torch.equal(res["color"], ref.color) and torch.equal(res["depth"], ref.depth)
    assert torch.equal(res["visible"], ref.visible)
    assert res["n_overflow"] == int(ref.n_overflow)
    assert float((1.0 - ref.final_T).max()) > 0.3

    jm, jr = _jm(RENDER_MODEL), _jr()
    jbg = jnp.asarray([0.1, 0.9], jnp.float32)
    jout = jax.jit(lambda p: jrender(p, jvalid, jframe, jm, jr, jbg)[0])(jparams)
    assert_close_up_to_flips(res["color"].numpy(), np.asarray(jout.color), 1e-5, 2e-2)
    assert_close_up_to_flips(res["depth"].numpy(), np.asarray(jout.depth), 1e-4, 2.0)

    def loss(p):
        o = jrender(p, jvalid, jframe, jm, jr, jbg)[0]
        return jnp.mean(o.color ** 2) + 0.01 * jnp.mean(o.depth)

    jg = jax.tree.leaves(jax.jit(jax.grad(loss))(jax.tree.map(jnp.asarray, jparams)))
    assert len(jg) == len(res["grads"])
    for a, b in zip(res["grads"], jg):
        np.testing.assert_allclose(a, np.asarray(b), atol=3e-5, rtol=2e-3)
    assert max(float(np.abs(g).max()) for g in res["grads"]) > 0


def _jr():
    from lidargs_tpu.config import RasterConfig

    return RasterConfig(**RENDER_RASTER)


CLI_BASE = ["--voxel_size", "8.0", "--anchor_capacity", "2048", "--max_visible", "4096",
            "--tile_capacity", "64", "--log_every", "2", "--iterations", "4",
            "--test_iterations", "4", "--save_iterations", "4"]


def test_cli_fleet_writes_once_and_matches_one_process(tmp_path):
    from test_data_cli import _make_dataset

    from lidargs_torch.data.scene import Scene
    from lidargs_torch.train import cli

    data, out, one = tmp_path / "data", tmp_path / "fleet", tmp_path / "one"
    _make_dataset(str(data))
    rec = launch_fleet([sys.executable, "-m", "lidargs_torch.train.cli", "-s", str(data),
                        "-m", str(out), *CLI_BASE, "--mp_platform", "cpu", "--dp_batch", "2"],
                       2, tmp_path / "logs", record=out / "results.json", timeout=300,
                       env={"OMP_NUM_THREADS": "1"})
    assert np.isfinite(rec["test"]["intensity_psnr"])
    assert (out / "outputs.p1.log").exists() and not (out / "outputs.p0.log").exists()
    assert "backend gloo" in (out / "outputs.p1.log").read_text()
    assert sorted(p.name for p in out.iterdir()) == sorted([
        "cfg_args.json", "outputs.log", "outputs.p1.log", "per_view.json", "point_cloud",
        "points3d.ply", "results.json"])
    cli.main(["-s", str(data), "-m", str(one), *CLI_BASE, "--device", "cpu",
              "--data_parallel", "1", "--dp_batch", "2"])
    mcfg = TM(anchor_capacity=2048)
    a = Scene._load_field(str(out), 4, mcfg, "cpu")
    b = Scene._load_field(str(one), 4, mcfg, "cpu")
    assert torch.equal(a.valid, b.valid) and int(a.valid.sum()) > 0
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-5, rtol=0)


def test_scaling_harness_runs_fleets(tmp_path, monkeypatch):
    """`measure_dp_scaling` starts a fleet of 1 and of 2 CPU processes
    through the launcher and reports sane records (a CPU rate measures the
    harness, not a device)."""
    from lidargs_torch.parallel.scaling import measure_dp_scaling

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    recs = measure_dp_scaling(
        TM(feat_dim=8, n_offsets=2, mlp_hidden=8, anchor_capacity=512),
        TR(max_visible=1024, max_tiles_per_gaussian=8, tile_capacity=32, chunk=8),
        TO(start_stat=10 ** 9), H=8, W=256, n_points=1500, process_counts=[1, 2], steps=2,
        warmup=1, voxel_size=12.0, platform="cpu", log_dir=tmp_path, timeout=300)
    assert [(r["devices"], r["hosts"]) for r in recs] == [(1, 1), (2, 2)]
    assert all(r["rays_per_s"] > 0 and np.isfinite(r["efficiency"]) for r in recs)
    assert recs[0]["efficiency"] == 1.0 and recs[0]["ranks_per_card"] is None


# each rank says hello; with "fail", rank 1 exits 3 once rank 0's hello is
# in its log (argv[2], the launcher's log directory), so the launcher's
# kill cannot come before it
RANK_SCRIPT = ("import pathlib, sys, time; r = sys.argv[sys.argv.index('--process_id') + 1]; "
               "print('rank', r, 'says hello', flush=True); "
               "log0 = pathlib.Path(sys.argv[2]) / 'rank0.log'; t = time.monotonic() + 15\n"
               "while r == '1' and 'fail' in sys.argv and time.monotonic() < t:\n"
               "    if 'says hello' in log0.read_text(): sys.exit(3)\n"
               "    time.sleep(0.05)\n"
               "time.sleep(60)")


@pytest.mark.parametrize("mode", ["fail", "timeout"])
def test_launcher_kills_the_fleet_and_raises_with_the_logs(tmp_path, mode):
    """A rank that exits non-zero, or a fleet past its time, ends every
    rank and raises with each rank's log tail."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exit codes") as err:
        launch_fleet([sys.executable, "-c", RANK_SCRIPT, mode, str(tmp_path)], 2, tmp_path,
                     timeout=30 if mode == "fail" else 2)
    assert time.monotonic() - t0 < 20
    msg = str(err.value)
    assert "rank 1 says hello" in msg and "rank 0 says hello" in msg
    assert ("timed out" in msg) == (mode == "timeout")
    assert ("3" in msg.split("exit codes")[1].split("\n")[0]) == (mode == "fail")
