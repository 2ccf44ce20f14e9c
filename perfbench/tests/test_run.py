"""A run without a card, or without the port beside the benchmark, fails and
prints no result; the module check compares whole top-level names; a run's
process loads none of the JAX stack."""

import os
import shutil
import subprocess
import sys

from perfbench import harness
from perfbench.tests.tiny import tiny_run

CELL = "maestro22k_bf16.restore_4seg"
CMD = ["perfbench/run.py", "--workload", CELL, "--seed", "3", "--seconds",
       "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, *CMD], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _run(harness.ROOT, env)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = _run(tmp_path, env)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_module_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "babe_tpu_torch_fake.x", sys)
    monkeypatch.delitem(sys.modules, "babe_tpu", raising=False)
    assert "babe_tpu" not in harness.loaded_modules()
    monkeypatch.setitem(sys.modules, "babe_tpu.fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert {"babe_tpu", "jaxlib"} <= set(harness.loaded_modules())


def test_a_run_loads_no_jax():
    """A whole tiny run in a fresh interpreter, then the check a run makes
    once its window has closed."""
    code = ("import sys; sys.path.insert(0, '.');"
            "from perfbench import harness;"
            "from perfbench.tests.tiny import tiny_run;"
            f"r = tiny_run({CELL!r});"
            "harness.loop(r.mix['kind']).run(r);"
            "print(harness.loaded_modules(), r.correct)")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_rates_and_checks_of_a_tiny_run():
    r = tiny_run("maestro22k_bf16.generate_4x8s", seconds=2.0)
    harness.loop(r.mix["kind"]).run(r)
    assert r.units > 0 and r.window_s >= 2.0 and r.setup_s > 0
    assert harness.read_metric("generate_audio_s_per_s", r) > 0
    assert set(r.checks) == {"den_err", "step_err"} and r.correct
