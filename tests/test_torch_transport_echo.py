"""The port's transport echo rig (``benchmarks/transport_echo.py`` with its
own copy of ``loopback_floor.c``) against the reference's, on the CPU.

Each line at small ``n`` has the reference's shape; ``main`` prints the
reference's paths and keys, the floor included; the floor is built from
the port's C copy into ``build/torch_native/`` and raises without a C
compiler (the reference skips it); the two-process form's child imports
the port's transport even where the reference package is unimportable.
"""

import json
import os
from pathlib import Path

import pytest

import benchmarks.transport_echo as ref_te
from multiraft_tpu.distributed.native import native_available
from multiraft_tpu_torch.benchmarks import transport_echo as te

REPO = Path(__file__).resolve().parents[1]

needs_native = pytest.mark.skipif(
    not native_available(), reason="native transport did not build"
)


def test_sim_echo_returns_a_latency_as_the_reference():
    ours, ref = te.bench_sim(2_000), ref_te.bench_sim(2_000)
    assert isinstance(ours, float) and isinstance(ref, float)
    assert ours > 0 and ref > 0


@needs_native
@pytest.mark.parametrize("name", ["bench_native", "bench_native_2proc"])
def test_native_echo_returns_min_and_median(name):
    lo, med = getattr(te, name)(500)
    assert 0 < lo <= med


@needs_native
def test_the_two_process_child_imports_the_port(tmp_path, monkeypatch):
    """The child runs with ``multiraft_tpu`` and ``jax`` made
    unimportable (a ``sitecustomize`` on its ``PYTHONPATH``), so only the
    port's transport can serve it."""
    (tmp_path / "sitecustomize.py").write_text(
        "import sys\n"
        "sys.modules['multiraft_tpu'] = None\n"
        "sys.modules['jax'] = None\n"
    )
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    lo, med = te.bench_native_2proc(200)
    assert 0 < lo <= med


def test_the_floor_builds_from_the_ports_copy():
    assert Path(te.FLOOR_SRC) == REPO / "multiraft_tpu_torch" / "benchmarks" / (
        "loopback_floor.c"
    )
    ours = Path(te.FLOOR_SRC).read_text()
    ref = (REPO / "benchmarks" / "loopback_floor.c").read_text()
    # The same program: only the header comment differs.
    assert ours[ours.index("#include"):] == ref[ref.index("#include"):]
    exe = te.floor_executable()
    assert Path(exe).parent == REPO / "build" / "torch_native"
    assert os.access(exe, os.X_OK)
    lo, med = te.bench_floor(1_000)
    ref_lo, ref_med = ref_te.bench_floor(1_000)
    assert 0 < lo <= med and 0 < ref_lo <= ref_med


def test_the_floor_raises_without_a_c_compiler(tmp_path, monkeypatch):
    monkeypatch.setattr(te, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(te.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C compiler"):
        te.bench_floor(100)
    assert not list(tmp_path.iterdir())


@needs_native
@pytest.mark.timeout_s(180)
def test_main_prints_the_references_lines(capsys):
    te.main(["transport_echo"])
    ours = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    ref_te.main(["transport_echo"])
    ref = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [d["path"] for d in ours] == [
        "sim", "native", "native_2proc", "loopback_floor_c", "gap",
    ]
    assert [d["path"] for d in ours] == [d["path"] for d in ref]
    for a, b in zip(ours, ref):
        assert set(a) == set(b), a["path"]
        if "n" in a:
            assert a["n"] == b["n"]
    assert ours[-1]["framework_us_over_floor"] > 0
