"""The port's durable engine KV server and its clerks, over real sockets.

* Three concurrent port ``EngineClerk``s against the port's
  ``serve_engine_kv(device="cpu")``: the wall-clock history passes the
  reference's porcupine checker and every append tag appears exactly
  once (after ``tests/test_distributed.py``'s engine-over-TCP test).
* Both cross-package pairs: the reference's clerk against the port's
  server, and the port's clerk against the reference's in-process
  ``serve_engine_kv``; one wire, so every op lands once.
* ``PipelinedClerk`` batch frames and ``FirehoseClerk`` frames: every
  acknowledged row reads back.
* The command line, as an operator runs it: ``serve-kv --device cpu``
  prints ``ready <port>``, ``kv put/append/get`` round-trip, ``kill -9``
  and a restart on the same directory return every acknowledged value,
  SIGTERM writes the final checkpoint, and ``serve-kv`` without
  ``--device`` on a host without a card exits non-zero before ``ready``.
"""

import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from multiraft_tpu.porcupine.kv import OP_APPEND, OP_GET, KvInput, KvOutput, kv_model
from multiraft_tpu.porcupine.model import Operation
from multiraft_tpu.porcupine.visualization import assert_linearizable
from multiraft_tpu_torch.distributed.engine_server import (
    EngineClerk,
    FirehoseClerk,
    PipelinedClerk,
    serve_engine_kv,
)
from multiraft_tpu_torch.distributed.native import native_available
from multiraft_tpu_torch.distributed.tcp import RpcNode
from multiraft_tpu_torch.distributed.wal import WriteAheadLog
from multiraft_tpu_torch.sim.scheduler import TIMEOUT

# Small shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the host's cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native transport did not build"
)


class Clerk:
    """A blocking port clerk of its own node (one per client thread)."""

    def __init__(self, port, cls=EngineClerk):
        self.node = RpcNode()
        self.ck = cls(self.node.sched, self.node.client_end("127.0.0.1", port))
        self.client_id = self.ck.client_id

    def run(self, gen, timeout=60.0):
        out = self.node.sched.wait(self.node.sched.spawn(gen), timeout)
        assert out is not TIMEOUT, "clerk op timed out"
        return out

    def get(self, key):
        return self.run(self.ck.get(key))

    def put(self, key, value):
        return self.run(self.ck.put(key, value))

    def append(self, key, value):
        return self.run(self.ck.append(key, value))

    def close(self):
        self.node.close()


@pytest.fixture(scope="module")
def port_server(tmp_path_factory):
    node = serve_engine_kv(
        0, G=16, seed=3, device="cpu",
        data_dir=str(tmp_path_factory.mktemp("served")),
    )
    yield node
    node.close()


def test_concurrent_clerks_linearizable_and_exactly_once(port_server):
    history = []
    lock = threading.Lock()
    keys = ["ha", "hb"]
    errors = []

    def worker(wid):
        ck = Clerk(port_server.port)
        try:
            for j in range(8):
                key = keys[(wid + j) % len(keys)]
                t0 = time.monotonic()
                if j % 3 == 2:
                    v = ck.get(key)
                    inp, out = KvInput(op=OP_GET, key=key), KvOutput(value=v)
                else:
                    tag = f"({wid}.{j})"
                    ck.append(key, tag)
                    inp = KvInput(op=OP_APPEND, key=key, value=tag)
                    out = KvOutput(value="")
                with lock:
                    history.append(Operation(
                        client_id=ck.client_id, input=inp, call=t0,
                        output=out, ret=time.monotonic(),
                    ))
        except BaseException as e:  # surfaced below
            errors.append(e)
        finally:
            ck.close()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    ck = Clerk(port_server.port)
    try:
        for key in keys:
            v = ck.get(key)
            for wid in range(3):
                for j in range(8):
                    tag = f"({wid}.{j})"
                    expected = keys[(wid + j) % len(keys)] == key and j % 3 != 2
                    assert v.count(tag) == (1 if expected else 0), (tag, key, v)
    finally:
        ck.close()
    assert len(history) == 24
    assert_linearizable(kv_model, history, timeout=30.0, name="port-engine-over-tcp")
    snap = port_server.obs.metrics.snapshot()
    assert snap.get("kv.writes", 0) >= 16 and snap.get("pump.count", 0) > 0


def test_reference_clerk_against_port_server(port_server):
    from multiraft_tpu.distributed.engine_cluster import BlockingEngineClerk

    ref = BlockingEngineClerk(port_server.port)
    port = Clerk(port_server.port)
    try:
        ref.put("xr", "ref")
        port.append("xr", "+port")
        ref.append("xr", "+ref")
        assert ref.get("xr") == port.get("xr") == "ref+port+ref"
    finally:
        ref.close()
        port.close()


def test_port_clerk_against_reference_server():
    from multiraft_tpu.distributed.engine_cluster import BlockingEngineClerk
    from multiraft_tpu.distributed.engine_server import serve_engine_kv as ref_serve

    node = ref_serve(0, G=8, seed=31)
    port = Clerk(node.port)
    ref = BlockingEngineClerk(node.port)
    try:
        port.put("yr", "port")
        ref.append("yr", "+ref")
        port.append("yr", "+port")
        assert port.get("yr") == ref.get("yr") == "port+ref+port"
        pc = Clerk(node.port, PipelinedClerk)
        try:
            got = pc.run(pc.ck.run_batch(
                [("Append", f"b{i % 3}", f"[{i}]") for i in range(9)]
                + [("Get", "b1", "")]
            ))
            assert got[-1] == "[1][4][7]"
        finally:
            pc.close()
    finally:
        port.close()
        ref.close()
        node.close()


def test_pipelined_batch_frames_read_back(port_server):
    ck = Clerk(port_server.port, PipelinedClerk)
    try:
        ops = []
        want = {}
        for i in range(300):
            key = f"p{i % 37}"
            if i % 5 == 0:
                ops.append(("Put", key, f"<{i}>"))
                want[key] = f"<{i}>"
            else:
                ops.append(("Append", key, f"<{i}>"))
                want[key] = want.get(key, "") + f"<{i}>"
        ops += [("Get", k, "") for k in sorted(want)]
        got = ck.run(ck.ck.run_batch(ops))
        assert got[-len(want):] == [want[k] for k in sorted(want)]
        # Whole-frame retry under the same command ids applies nothing twice.
        ck.ck.command_id -= 300
        ck.run(ck.ck.run_batch(ops[:300]))
        reader = Clerk(port_server.port)
        try:
            for k, v in want.items():
                assert reader.get(k) == v
        finally:
            reader.close()
    finally:
        ck.close()


def test_firehose_frames_read_back(port_server):
    ck = Clerk(port_server.port, FirehoseClerk)
    try:
        want = {}
        for frame in range(3):
            ops = []
            for i in range(500):
                key = f"f{(frame * 500 + i) % 211}"
                piece = f"{frame}.{i};"
                ops.append(("Append", key, piece))
                want[key] = want.get(key, "") + piece
            ck.run(ck.ck.run_batch(ops))
        got = ck.run(ck.ck.run_batch([("Get", k, "") for k in sorted(want)]))
        assert got == [want[k] for k in sorted(want)]
        snap = port_server.obs.metrics.snapshot()
        assert snap.get("firehose.rows", 0) >= 1500
    finally:
        ck.close()


def test_observability_scrape_reads_the_planes(port_server):
    from multiraft_tpu.harness import FleetObserver

    obs = FleetObserver([("127.0.0.1", port_server.port)])
    addr = ("127.0.0.1", port_server.port)
    snap = obs.snapshot(addr)
    groups = snap["groups"]
    assert groups["G"] == 16 and len(groups["leader"]) == 16
    assert all(0 <= lead < 3 for lead in groups["leader"])
    hist = obs.hist(addr)
    assert "pump.wall_s" in hist["hists"] and "gauge.backlog" in hist["gauges"]


# -- the command line ---------------------------------------------------------


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")
    env.update(extra)
    return env


def _serve(data, *flags, env=None):
    return subprocess.Popen(
        [sys.executable, "-m", "multiraft_tpu_torch", "serve-kv",
         "--groups", "16", "--data-dir", str(data), *flags],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        env=env or _env(), text=True,
    )


def _wait_ready(proc, timeout=120.0):
    line = proc.stdout.readline()
    assert line.startswith("ready "), (line, proc.poll())
    return int(line.split()[1])


def _kv(*args, package="multiraft_tpu_torch"):
    return subprocess.run(
        [sys.executable, "-m", package, "kv", *args],
        capture_output=True, text=True, env=_env(), timeout=120,
    )


def test_cli_roundtrip_and_kill_9_keeps_every_acked_write(tmp_path):
    data = tmp_path / "cli"
    proc = _serve(data, "--device", "cpu")
    try:
        addr = f"127.0.0.1:{_wait_ready(proc)}"
        assert _kv("put", "greeting", "hello", "--addr", addr).returncode == 0
        assert _kv("append", "greeting", " world", "--addr", addr).returncode == 0
        r = _kv("get", "greeting", "--addr", addr)
        assert r.returncode == 0 and r.stdout.strip() == "hello world", r.stderr
        r = _kv("put", "nothing", "--addr", addr)
        assert r.returncode == 2 and "requires a VALUE" in r.stderr
        ck = Clerk(int(addr.rsplit(":", 1)[1]))
        try:
            for i in range(20):
                ck.append("acked", f"<{i}>")
        finally:
            ck.close()
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
        assert (data / "ops.wal").stat().st_size > 0
        proc = _serve(data, "--device", "cpu")
        addr = f"127.0.0.1:{_wait_ready(proc)}"
        r = _kv("get", "acked", "--addr", addr)
        assert r.stdout.strip() == "".join(f"<{i}>" for i in range(20)), r.stderr
        # The reference package's CLI client speaks to the port's server.
        r = _kv("get", "greeting", "--addr", addr, package="multiraft_tpu")
        assert r.returncode == 0 and r.stdout.strip() == "hello world", r.stderr
    finally:
        proc.kill()
        proc.wait()
        proc.stdout.close()


def test_cli_sigterm_checkpoints_before_exit(tmp_path):
    data = tmp_path / "graceful"
    proc = _serve(data, "--device", "cpu", "--checkpoint-every", "3600")
    try:
        addr = f"127.0.0.1:{_wait_ready(proc)}"
        assert _kv("put", "grace", "ful", "--addr", addr).returncode == 0
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
        proc.stdout.close()
        assert (data / "engine.ckpt").exists()
        assert list(WriteAheadLog(str(data / "ops.wal"), fsync=False).replay()) == []
        proc = _serve(data, "--device", "cpu")
        r = _kv("get", "grace", "--addr", f"127.0.0.1:{_wait_ready(proc)}")
        assert r.returncode == 0 and r.stdout.strip() == "ful", r.stderr
    finally:
        proc.kill()
        proc.wait()
        proc.stdout.close()


def test_cli_serve_without_a_card_refuses_to_start(tmp_path):
    # No --device: the card.  With no card visible the server exits
    # non-zero and never prints its readiness line.
    proc = _serve(tmp_path / "nocard", env=_env(CUDA_VISIBLE_DEVICES=""))
    try:
        out, _ = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode != 0
    assert "ready" not in out
    assert not (tmp_path / "nocard" / "ops.wal").exists()
