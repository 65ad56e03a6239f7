"""The PyTorch port stands alone: nothing in ``multiraft_tpu_torch/`` or
in ``chip_smoke.py`` imports JAX, the reference package or the
benchmarks tree (whose open-loop generator imports the reference), the whole
package imports with JAX made unimportable, and an engine driver asked
for no device in particular wants the card and refuses to run without
one."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# Small shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the host's cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "multiraft_tpu_torch"


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    return files


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "multiraft_tpu", "benchmarks")


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_forbidden_names_are_recognised():
    assert _forbidden("jax.numpy") and _forbidden("multiraft_tpu.engine.core")
    assert not _forbidden("multiraft_tpu_torch.engine.core")


def test_a_benchmarks_import_is_caught(tmp_path):
    """The reference's nemesis reaches ``benchmarks.openloop`` lazily,
    inside a function; the scan walks function bodies too."""
    assert _forbidden("benchmarks.openloop") and _forbidden("benchmarks")
    planted = tmp_path / "planted.py"
    planted.write_text(
        "def surge():\n    from benchmarks.openloop import fire_schedule\n"
    )
    assert [m for m in _imported_modules(planted) if _forbidden(m)] == [
        "benchmarks.openloop"
    ]
    ref = REPO / "multiraft_tpu" / "harness" / "nemesis.py"
    assert "benchmarks.openloop" in list(_imported_modules(ref))


def test_whole_package_imports_with_jax_unimportable():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['multiraft_tpu'] = None\n"
        "sys.modules['benchmarks'] = None\n"
        "import multiraft_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'multiraft_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert 'multiraft_tpu_torch.engine.kv' in names, names\n"
        "for n in ('porcupine.checker', 'porcupine.native', 'porcupine.visualization',\n"
        "          'porcupine.register', 'porcupine.ctrler', 'distributed.stateplane',\n"
        "          'distributed.engine_shard_server', 'distributed.split_server',\n"
        "          'distributed.split_shard_server', 'distributed.launch',\n"
        "          'distributed.chaos', 'distributed.engine_cluster',\n"
        "          'distributed.cluster', 'utils.config', 'raft.messages',\n"
        "          'raft.log', 'raft.persister', 'raft.node', 'transport.network',\n"
        "          'harness.cluster', 'harness.raft_harness', 'harness.kv_harness',\n"
        "          'harness.ctrler_harness', 'harness.shardkv_harness', 'conformance',\n"
        "          'services.backend', 'services.kvraft', 'services.shardctrler',\n"
        "          'services.shardkv', 'engine.bench_verify',\n"
        "          'distributed.placement', 'harness.fleet', 'harness.observe',\n"
        "          'harness.bundle', 'harness.nemesis', 'harness._openloop',\n"
        "          'harness.loadcurve', 'harness.split_harness',\n"
        "          'analysis.postmortem', 'engine.mesh', 'analysis.core',\n"
        "          'analysis.dataflow', 'analysis.lockgraph', 'analysis.planes',\n"
        "          'analysis.registry', 'analysis.rules', 'analysis.__main__',\n"
        "          'soak', 'utils.knobs', 'bench', 'benchmarks.roofline',\n"
        "          'benchmarks.scenarios'):\n"
        "    assert 'multiraft_tpu_torch.' + n in names, n\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 12


def test_bench_has_no_platform_pin():
    """``bench.py`` pins JAX's platform (``jax.config.update``) for
    ``MULTIRAFT_BENCH_PLATFORM``; the port's bench reads the same knob as
    a device and pins nothing."""
    for rel in ("bench.py", "benchmarks/roofline.py", "benchmarks/scenarios.py"):
        text = (PORT / rel).read_text()
        assert "jax" not in text.lower(), rel
    assert "jax.config.update" in (REPO / "bench.py").read_text()
    assert "MULTIRAFT_BENCH_PLATFORM" in (PORT / "bench.py").read_text()


def test_driver_without_device_wants_the_card(monkeypatch):
    from multiraft_tpu_torch.engine.core import EngineConfig
    from multiraft_tpu_torch.engine.host import EngineDriver, resolve_device

    if torch.cuda.is_available():
        assert resolve_device(None) == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineDriver(EngineConfig(G=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineDriver(EngineConfig(G=2), device="cuda")
    d = EngineDriver(EngineConfig(G=2), device="cpu")
    assert d.state.term.device.type == "cpu"


def test_knobs_read_the_reference_names_with_its_defaults(monkeypatch):
    from multiraft_tpu.utils import knobs as ref_knobs
    from multiraft_tpu_torch.utils import knobs

    for name, default in knobs.BOOL_KNOBS.items():
        monkeypatch.delenv(name, raising=False)
        assert knobs.knob_bool(name) == ref_knobs.knob_bool(name) == default
        for raw in ("0", "off", "1", "yes", ""):
            monkeypatch.setenv(name, raw)
            assert knobs.knob_bool(name) == ref_knobs.knob_bool(name)
    with pytest.raises(KeyError):
        knobs.knob_bool("MRT_NOT_A_KNOB")


def test_every_port_knob_is_the_references(monkeypatch):
    """Each knob the port reads has the reference's name, type and
    default, and every typed reader parses as the reference's does."""
    from multiraft_tpu.utils import knobs as ref_knobs
    from multiraft_tpu_torch.utils import knobs

    ref = {k.name: k for k in ref_knobs.KNOBS}
    assert len(knobs.KNOBS) >= 40
    samples = {"int": ("7", "", "junk"), "float": ("0.5", "", "x"),
               "str": ("/tmp/x", ""), "bool": ("0", "on", "")}
    for k in knobs.KNOBS:
        name, typ, default = k.name, k.type, k.default
        assert (ref[name].type, ref[name].default) == (typ, default), name
        port_read = getattr(knobs, f"knob_{typ}")
        ref_read = getattr(ref_knobs, f"knob_{typ}")
        extra = {} if default is not None or typ in ("str", "bool") else {"default": 3}
        for raw in samples[typ]:
            monkeypatch.setenv(name, raw)
            assert port_read(name, **extra) == ref_read(name, **extra), (name, raw)
        monkeypatch.delenv(name)
        assert port_read(name, **extra) == ref_read(name, **extra), name
        wrong = "int" if typ != "int" else "str"
        with pytest.raises(TypeError):
            getattr(knobs, f"knob_{wrong}")(name)


# The host-side modules the port copies from the reference, by their
# shared path: each keeps every public name of its counterpart.
HOST_MODULES = (
    "utils.config", "raft.messages", "raft.log", "raft.persister", "raft.node",
    "transport.network", "harness.cluster", "harness.raft_harness",
    "harness.kv_harness", "harness.ctrler_harness", "harness.shardkv_harness",
    "conformance", "services.backend", "services.kvraft",
    "services.shardctrler", "services.shardkv", "engine.bench_verify",
    "distributed.placement", "distributed.cluster", "harness",
    "harness.fleet", "harness.observe", "harness.bundle", "harness.nemesis",
    "harness.loadcurve", "harness.split_harness", "analysis.postmortem",
    "engine.mesh", "analysis", "analysis.core", "analysis.dataflow",
    "analysis.lockgraph", "analysis.planes", "analysis.registry",
    "utils.knobs",
)


@pytest.mark.parametrize("name", HOST_MODULES)
def test_host_module_has_the_reference_public_names(name):
    import importlib

    ref = importlib.import_module(f"multiraft_tpu.{name}")
    port = importlib.import_module(f"multiraft_tpu_torch.{name}")
    names = getattr(ref, "__all__", None) or [
        n for n in vars(ref) if not n.startswith("_")
    ]
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, f"multiraft_tpu_torch.{name} lacks {missing}"


def test_sim_messages_travel_under_the_reference_names():
    """The messages the simulated network copies through the codec are
    registered, under the reference package's module names."""
    import multiraft_tpu.raft.messages as ref_msgs
    import multiraft_tpu.transport.codec as ref_codec
    from multiraft_tpu_torch.raft import messages
    from multiraft_tpu_torch.services import kvraft, shardctrler, shardkv
    from multiraft_tpu_torch.transport import codec

    for mod in (messages, kvraft, shardctrler, shardkv):
        for cls in vars(mod).values():
            if isinstance(cls, type) and cls.__module__ == mod.__name__ and (
                cls.__qualname__ in codec._REGISTRY
            ):
                assert codec.wire_module(cls) == mod.__name__.replace(
                    "multiraft_tpu_torch", "multiraft_tpu"
                )
    args = messages.AppendEntriesArgs(
        term=3, leader_id=1, prev_log_index=2, prev_log_term=1,
        entries=[messages.Entry(index=3, term=3, command="x")], leader_commit=2,
    )
    ref_args = ref_msgs.AppendEntriesArgs(
        term=3, leader_id=1, prev_log_index=2, prev_log_term=1,
        entries=[ref_msgs.Entry(index=3, term=3, command="x")], leader_commit=2,
    )
    assert codec.encode(args) == ref_codec.encode(ref_args)
    assert codec.decode(ref_codec.encode(ref_args)) == args
