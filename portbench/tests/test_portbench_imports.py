"""What the harness loads: never JAX or the JAX package, and the reference
nothing of the port."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "lidargs_tpu"}


def loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_the_reference_loads_nothing_of_the_port():
    top = loaded_after("import portbench.reference.train, portbench.check, portbench.counts")
    assert "lidargs_torch" not in top and not top & FORBIDDEN


def test_a_whole_run_loads_no_jax():
    top = loaded_after(
        "import time, torch\n"
        "from portbench import run\n"
        "from portbench.tests.tiny import tiny_cell\n"
        "for name in ('beam-train-street', 'surfel-render-street'):\n"
        "    r = run.run_cell(tiny_cell(name), 7, 0.3, True, torch.device('cpu'),"
        " time.perf_counter())\n"
        "    assert r['correct'], r\n"
        "assert run.loaded_forbidden() == []\n")
    assert "lidargs_torch" in top and not top & FORBIDDEN


def test_the_harness_refuses_without_a_card():
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", "beam-train-street",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_harness_fails_without_the_port(tmp_path):
    import shutil

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", "beam-train-street",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
