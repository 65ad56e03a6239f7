"""No run loads JAX or the JAX package, and the command refuses a
machine without a card and a checkout without the program."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from cellbench.isolation import forbidden_modules
from cellbench.manifest import REPO, ROOT


def test_top_level_names_are_compared_whole():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "multiraft_tpu",
             "multiraft_tpu.engine.core", "multiraft_tpu_torch", "multiraft_tpu_torch.engine",
             "jaxtyping", "flaxen", "torch"]
    assert forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "multiraft_tpu",
         "multiraft_tpu.engine.core"])


RUN_AND_LIST = """
import json, sys, torch
from cellbench import control, harness, manifest, run
from cellbench.isolation import forbidden_modules
out = harness.run(manifest.cell("c5.skew_churn"), 3, 0.2, False, "cpu",
                  conf_override={"G": 24})
for m in manifest.load()["per_layer"]:
    manifest.reader(m["name"])
print(json.dumps({"bad": forbidden_modules(), "correct": out.correct,
                  "mods": sorted(n for n in sys.modules
                                 if n.split(".")[0] in ("bench", "benchmarks")
                                 or n == "multiraft_tpu_torch.bench")}))
"""


def test_a_run_loads_no_jax_and_the_port_passes():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", RUN_AND_LIST], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "correct": True, "mods": []}


def run_cmd(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "-m", "cellbench.run", "--workload", "c5.skew_churn",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_the_command_refuses_the_cpu():
    proc = run_cmd(REPO)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_the_command_fails_without_the_program(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT, tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = run_cmd(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "multiraft_tpu_torch" in proc.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_one_short_cell_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "cellbench.run", "--workload", "c5.skew_churn",
         "--seed", str(2**31 + 5 + trace), "--seconds", "4", "--trace", str(trace)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench[kind] if "c5.skew_churn" in m.get("workloads", ["c5.skew_churn"])}
    assert set(line["metrics"]) == want
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["breakdown"]["device_ops"] and line["breakdown"]["idle_gaps"]
        for name, m in line["metrics"].items():
            if m["unit"] == "%":
                assert 0 < m["value"] <= 100, name
    assert list(line)[-1] == "compared"
    assert proc.stderr.strip().splitlines()[-1].startswith("compared ")
