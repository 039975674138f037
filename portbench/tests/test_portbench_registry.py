"""A configuration, a traffic mix and a metric added as new files and
entries are found by name; no file that was there changes."""
import hashlib
import json
import shutil
from pathlib import Path

from portbench import registry

ROOT = Path(__file__).resolve().parents[2]


def digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_and_metric_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = digests(tmp_path)
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "lidargs-beam-waymo64.json").read_text())
    cfg["name"] = "lidargs-beam-fitcap"
    cfg["model"]["anchor_capacity"] = 65536
    (pb / "configs" / "lidargs-beam-fitcap.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "traffic" / "train-street.json").read_text())
    traffic["log_every"] = 50
    (pb / "traffic" / "train-quiet.json").write_text(json.dumps(traffic))
    (pb / "limits" / "beam-train-quiet.json").write_text(
        (pb / "limits" / "beam-train-street.json").read_text())
    (pb / "metrics" / "iterations_per_s.py").write_text(
        "def read(rec):\n    return rec.iterations / rec.window_s\n")
    bench["configs"].append({"name": "lidargs-beam-fitcap", "source": "x",
                             "file": "portbench/configs/lidargs-beam-fitcap.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "beam-train-quiet", "config": "lidargs-beam-fitcap",
                               "traffic": "train-quiet", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "iterations_per_s", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "entry (graphs)",
                               "moves": "train_step_ms", "workloads": ["beam-train-quiet"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = registry.load_cell("beam-train-quiet", root=tmp_path)
    assert cell.config["model"]["anchor_capacity"] == 65536
    assert cell.traffic["log_every"] == 50
    assert [m["name"] for m in cell.per_layer][-1] == "iterations_per_s"
    assert "iterations_per_s" not in [m["name"] for m in
                                      registry.load_cell("beam-train-street",
                                                         root=tmp_path).per_layer]
    read = registry.reader("iterations_per_s", root=tmp_path)
    assert read(type("R", (), {"iterations": 30, "window_s": 2.0})) == 15.0
    after = digests(tmp_path)
    assert all(after[k] == v for k, v in before.items())
