"""A stage that a configuration names is found as new files under
`stages/`, drawn once in set-up, handed to the port's `Trainer`, held to
its reference and counted; a stage that cannot be is refused at load."""
import json
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import counts, readers, registry, run
from portbench.tests.test_portbench_registry import ROOT, digests
from portbench.tests.tiny import tiny_cell
from portbench.tracing import TraceSummary

CPU = torch.device("cpu")
SEED = 2 ** 31 + 23
CELL = "beam-render-street"
STAGED = "beam-render-staged"

NOP = '''KINDS = ("render",)


def draw(cell, seed, dev):
    return {"seed": seed}


def program(drawn):
    return {}


def reference(drawn, color, depth):
    return color, depth


def work(drawn, H, W):
    return 0, 0
'''
EAGER = NOP.replace('return {}', 'return {"graphed": False}')
DROP = "import torch\n" + NOP.replace(  # 0.05 added to the ray drop, channel 1
    "return color, depth", "return color + torch.tensor([[[0.0]], [[0.05]]]), depth")
COUNTED = NOP.replace("return 0, 0", "return 1000 * H * W, 12 * H * W")
TRAIN = NOP.replace('KINDS = ("render",)', 'KINDS = ("render", "train")')
PARTLESS = NOP.split("def work")[0]
JAXY = NOP.replace("    return {}", "    import jax  # noqa: F401\n    return {}")


def harness_with(tmp_path, stage_files: dict, names: list, traffic: str = "render-street"):
    """A copy of the harness at `tmp_path` with the stage files added and a
    cell `beam-<kind>-staged` whose configuration names `names`, all as new
    files and entries; the files that were there are checked unchanged."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(tmp_path)
    pb = tmp_path / "portbench"
    (pb / "stages").mkdir(exist_ok=True)
    for name, source in stage_files.items():
        (pb / "stages" / f"{name}.py").write_text(source)
    cfg = json.loads((pb / "configs" / "lidargs-beam-waymo64.json").read_text())
    cfg["name"], cfg["stages"] = "lidargs-beam-staged", names
    (pb / "configs" / "lidargs-beam-staged.json").write_text(json.dumps(cfg))
    kind = traffic.split("-")[0]
    cell = f"beam-{kind}-staged"
    (pb / "limits" / f"{cell}.json").write_text(
        (pb / "limits" / f"beam-{kind}-street.json").read_text())
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "lidargs-beam-staged", "source": "x",
                             "file": "portbench/configs/lidargs-beam-staged.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": cell, "config": "lidargs-beam-staged",
                               "traffic": traffic, "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = digests(tmp_path)
    assert all(after[k] == v for k, v in before.items())
    return tmp_path


def one_run(cell, trace: bool = False):
    return run.run_cell(cell, SEED, 0.3, trace, CPU, time.perf_counter())


def test_a_nop_stage_is_drawn_once_and_leaves_the_cell_as_it_was(tmp_path):
    root = harness_with(tmp_path, {"nop": NOP}, ["nop"])
    cell = tiny_cell(STAGED, root)
    (stage,) = cell.stages
    assert stage.name == "nop" and stage.kinds == ("render",)
    draws = []
    counted = stage._replace(draw=lambda *a: draws.append(a) or stage.draw(*a))
    staged = one_run(cell._replace(stages=(counted,)), trace=True)
    assert len(draws) == 1 and draws[0][1] == SEED
    plain = one_run(tiny_cell(CELL), trace=True)
    assert staged["correct"] and staged["check"] == plain["check"]
    assert staged["work"].pop("stage:nop") == {"ops": 0, "bytes": 0}
    assert staged["work"] == plain["work"]


def test_program_arguments_reach_the_trainer(tmp_path):
    root = harness_with(tmp_path, {"nop": NOP, "eager": EAGER}, ["nop", "eager"])
    cell = tiny_cell(STAGED, root, warm_frames=0)
    inputs = run.make_inputs(cell, SEED, CPU)
    drive, _, stages = run.make_drive(cell, SEED, inputs, CPU)
    assert [s.name for s, _ in stages] == ["nop", "eager"]
    assert [d for _, d in stages] == [{"seed": SEED}] * 2
    assert drive.trainer.graphed is False
    plain, _, none = run.make_drive(tiny_cell(CELL, warm_frames=0), SEED, inputs, CPU)
    assert plain.trainer.graphed is None and none == []


def test_a_stage_reference_that_moves_the_ray_drop_fails_the_check(tmp_path):
    root = harness_with(tmp_path, {"drop": DROP}, ["drop"])
    res = one_run(tiny_cell(STAGED, root))
    assert not res["correct"]
    for k in ("median_err", "far_share"):
        assert res["check"][k]["value"] > res["check"][k]["limit"], res["check"]


def test_a_stage_work_is_recorded_and_divided_by_mfu(tmp_path, monkeypatch):
    root = harness_with(tmp_path, {"counted": COUNTED}, ["counted"])
    bench = json.loads((root / "BENCHMARK.json").read_text())
    next(m for m in bench["per_layer"] if m["name"] == "mfu.render")["workloads"].append(STAGED)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = tiny_cell(STAGED, root)
    records = []
    read = registry.reader
    monkeypatch.setattr(registry, "reader",
                        lambda name: lambda rec: records.append(rec) or read(name)(rec))
    res = one_run(cell, trace=True)
    H, W = cell.config["sensor"]["H"], cell.config["sensor"]["W"]
    assert res["correct"]
    assert res["work"]["stage:counted"] == {"ops": 1000 * H * W, "bytes": 12 * H * W}
    rec = records[0]
    assert all(w.stages == (("counted", counts.Bound(12 * H * W, 1000 * H * W)),)
               for w in rec.work)
    # a traced frame of one second: mfu is the frame's operations over the peak
    one_s = TraceSummary(1.0, 1.0, 1, {}, [], 1)
    with_stage = SimpleNamespace(**{**vars(rec), "trace": one_s})
    without = SimpleNamespace(**{**vars(with_stage),
                                 "work": [w._replace(stages=()) for w in rec.work]})
    gained = readers.mfu(with_stage, "render") - readers.mfu(without, "render")
    assert gained == pytest.approx(100.0 * 1000 * H * W / counts.PEAK_FP32_OPS_PER_S)


@pytest.mark.parametrize("files, names, traffic, error, words", [
    ({}, ["absent"], "render-street", FileNotFoundError, ["absent", "stages/absent.py"]),
    ({"nop": NOP}, ["nop"], "train-street", ValueError,
     ["nop", "beam-train-staged", "'render'", "'train'"]),
    ({"both": TRAIN}, ["both"], "render-street", ValueError, ["both", "'train'"]),
    ({"partless": PARTLESS}, ["partless"], "render-street", AttributeError,
     ["partless", "'work'"]),
], ids=["unknown", "render-only-on-train", "train-stage", "missing-part"])
def test_a_stage_that_cannot_apply_is_refused_at_load(tmp_path, files, names, traffic, error,
                                                      words):
    root = harness_with(tmp_path, files, names, traffic)
    with pytest.raises(error) as e:
        registry.load_cell(f"beam-{traffic.split('-')[0]}-staged", root)
    assert all(w in str(e.value) for w in words), str(e.value)


def test_a_stage_that_loads_jax_leaves_no_result(tmp_path):
    root = harness_with(tmp_path, {"jaxy": JAXY}, ["jaxy"])
    code = (
        "import io, sys, time, torch\n"
        "from pathlib import Path\n"
        "from portbench import run\n"
        "from portbench.tests.tiny import tiny_cell\n"
        f"cell = tiny_cell({STAGED!r}, Path({str(root)!r}))\n"
        "assert run.loaded_forbidden() == []\n"
        "res = run.run_cell(cell, 7, 0.2, False, torch.device('cpu'), time.perf_counter())\n"
        "out, err = io.StringIO(), io.StringIO()\n"
        "rc = run.emit(res, out, err)\n"
        "print(json.dumps([rc, run.loaded_forbidden(), out.getvalue(), err.getvalue()]))\n")
    done = subprocess.run([sys.executable, "-c", "import json\n" + code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]
    rc, found, out, err = json.loads(done.stdout.strip().splitlines()[-1])
    assert rc == 3 and "jax" in found and out == ""
    assert err.startswith("portbench: the process loaded") and "'jax'" in err

