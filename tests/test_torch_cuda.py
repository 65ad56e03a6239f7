"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip without
them.  On a machine with a card, run them with::

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from multiraft_tpu_torch import convert
from multiraft_tpu_torch.engine import kernels
from multiraft_tpu_torch.engine.core import EngineConfig
from multiraft_tpu_torch.engine.host import EngineDriver
from torch_parity import same_delayed

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _commit_inputs(rng, G, P, L):
    base = rng.integers(0, 5, (G, P)).astype(np.int32)
    last = base + rng.integers(0, L - 6, (G, P)).astype(np.int32)
    return (
        rng.integers(-2, 20, (G, P, P)).astype(np.int32).clip(max=last[..., None]),
        rng.integers(1, 6, (G, P)).astype(np.int32),
        np.minimum(rng.integers(0, 10, (G, P)), last).astype(np.int32),
        base,
        rng.integers(0, 6, (G, P)).astype(np.int32),
        rng.integers(1, 6, (G, P, L)).astype(np.int32),
        rng.random((G, P)) < 0.4,
    )


def _groups(card, P, edge):
    """G for a row count (G*P) at an edge of the kernels' tiles of T rows:
    the multiple of P nearest 1, T-1, T or T+1 on its side, 37 groups, or
    enough rows that every persistent block of either kernel walks at
    least three full tiles (a stage's barrier then completes twice, so a
    wait on the wrong phase parity reads a stale tile)."""
    T = kernels.TILE
    if edge == "multi":
        sms = torch.cuda.get_device_properties(card).multi_processor_count
        grid = max(kernels.tile_plan(10**9, P, k, sms).grid
                   for k in ("quorum_commit", "vote_tally"))
        G = -(-(3 * grid * T + 1) // P)
        for k in ("quorum_commit", "vote_tally"):
            # Block b walks the full tiles b, b + grid, ...: at least 3.
            assert G * P // T >= 3 * kernels.tile_plan(G * P, P, k, sms).grid
        return G
    return {"1": 1, "T-1": max(1, (T - 1) // P), "T": max(1, T // P),
            "T+1": T // P + 1, "37": 37}[edge]


@pytest.mark.parametrize("edge", ["1", "T-1", "T", "T+1", "37", "multi"])
@pytest.mark.parametrize("P", [1, 2, 3, 4, 5, 7, 8, 9, 16, 31, 32])
def test_kernels_equal_plain_versions(card, P, edge):
    rng = np.random.default_rng(P)
    G, L, quorum = _groups(card, P, edge), 16, P // 2 + 1
    args = [torch.from_numpy(a).to(card) for a in _commit_inputs(rng, G, P, L)]
    got = kernels.quorum_commit(*args, quorum)
    assert torch.equal(got, kernels.quorum_commit_plain(*args, quorum))
    votes = torch.from_numpy(rng.random((G, P, P)) < 0.5).to(card)
    role = torch.from_numpy(rng.integers(0, 3, (G, P)).astype(np.int32)).to(card)
    alive = torch.from_numpy(rng.random((G, P)) < 0.8).to(card)
    got = kernels.vote_tally(votes, role, alive, quorum)
    assert torch.equal(got, kernels.vote_tally_plain(votes, role, alive, quorum))
    torch.cuda.synchronize()


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    votes = torch.zeros((4, 33, 33), dtype=torch.bool, device=card)
    role = torch.zeros((4, 33), dtype=torch.int32, device=card)
    alive = torch.ones((4, 33), dtype=torch.bool, device=card)
    with pytest.raises(ValueError, match="P <= 32"):
        kernels.vote_tally(votes, role, alive, 17)
    votes = torch.zeros((4, 3, 3), dtype=torch.bool, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.vote_tally(votes, role[:, :3].t().contiguous().t(), alive[:, :3], 2)


def test_wrappers_refuse_unaligned_planes(card):
    """A bulk copy needs 16-byte aligned planes: a view at a 4-byte (or
    1-byte) offset raises before any launch."""
    rng = np.random.default_rng(3)
    G, P, L = 37, 3, 16
    args = [torch.from_numpy(a).to(card) for a in _commit_inputs(rng, G, P, L)]
    shifted = torch.empty(G * P + 1, dtype=torch.int32, device=card)[1:]
    shifted = shifted.view(G, P).copy_(args[2])
    with pytest.raises(ValueError, match="aligned"):
        kernels.quorum_commit(args[0], args[1], shifted, *args[3:], 2)
    votes = torch.zeros((G, P, P), dtype=torch.bool, device=card)
    role = torch.empty(G * P + 1, dtype=torch.int32, device=card)[1:].view(G, P)
    alive = torch.ones((G, P), dtype=torch.bool, device=card)
    with pytest.raises(ValueError, match="aligned"):
        kernels.vote_tally(votes, role, alive, 2)
    alive = torch.ones(G * P + 1, dtype=torch.bool, device=card)[1:].view(G, P)
    with pytest.raises(ValueError, match="aligned"):
        kernels.vote_tally(votes, role.clone(), alive, 2)


def test_engine_on_the_card_equals_the_engine_on_the_cpu(card):
    cfg = EngineConfig(G=16, P=3, L=32, E=4, INGEST=4, use_kernels=True)
    worlds = []
    for dev in (card, "cpu"):
        d = EngineDriver(cfg, seed=6, device=dev)
        d.start_bulk(np.full(cfg.G, 200, np.int64))
        d.step(40)
        d.drop_prob = 0.1
        d.step(40)
        worlds.append((d.np_state(), convert.mailbox_to_numpy(d.inbox)))
    for a, b in zip(*worlds):
        for k in a:
            assert np.array_equal(a[k], b[k]), k


def _faulted_pair(card, seed=8):
    """The same G=64 driver on the card and on the CPU, under reorder,
    drops and a firehose backlog."""
    cfg = EngineConfig(G=64, P=3, L=32, E=4, INGEST=4, use_kernels=True)
    ds = [EngineDriver(cfg, seed=seed, device=dev) for dev in (card, "cpu")]
    for d in ds:
        d.set_reorder(2.0 / 3.0, 2, 10)
        d.drop_prob = 0.1
        d.start_bulk(np.full(cfg.G, 300, np.int64))
    return ds


def _assert_same_drivers(a, b):
    for x, y in ((a.np_state(), b.np_state()),
                 (convert.mailbox_to_numpy(a.inbox), convert.mailbox_to_numpy(b.inbox))):
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k
    assert a.commits_total == b.commits_total
    assert a._np_rng.bit_generator.state == b._np_rng.bit_generator.state
    assert same_delayed(a._delayed, b._delayed)


def test_restart_reset_and_reorder_on_the_card_equal_the_cpu(card):
    ds = _faulted_pair(card)
    for t in range(120):
        for d in ds:
            if t == 40:
                for g in range(0, 64, 8):
                    d.set_alive(g, g % 3, False)
            if t == 70:
                for g in range(0, 64, 8):
                    d.restart_replica(g, g % 3)
            if t == 80:
                d.reset_replica(5, 1)
                d.partition_replica(9, 2, False)
            d.step()
    assert ds[0]._delayed or ds[0].commits_total > 0
    _assert_same_drivers(*ds)


def test_checkpoints_cross_between_the_card_and_the_cpu(card, tmp_path):
    on_card, on_cpu = _faulted_pair(card, seed=9)
    for d in (on_card, on_cpu):
        d.step(50)
    paths = [str(tmp_path / "card.ckpt"), str(tmp_path / "cpu.ckpt")]
    on_card.save(paths[0])
    on_cpu.save(paths[1])
    card_to_cpu = EngineDriver.restore(paths[0], device="cpu")
    cpu_to_card = EngineDriver.restore(paths[1], device=card)
    assert card_to_cpu.state.term.device.type == "cpu"
    assert cpu_to_card.state.term.device.type == "cuda"
    drivers = (on_card, on_cpu, card_to_cpu, cpu_to_card)
    for d in drivers:
        d.restart_replica(3, 0)
        d.step(40)
    for d in drivers[1:]:
        _assert_same_drivers(on_card, d)


def test_sharded_service_on_the_card_equals_the_cpu(card):
    """The sharded script (join, writes, leave, move) at G=16 with the
    kernels on the card and their plain versions on the CPU: every
    plane and the whole service state equal after every pump, and
    every ticket resolved the same way."""
    from chip_smoke import _sharded_script
    from multiraft_tpu_torch.engine.shardkv import BatchedShardKV
    from torch_parity import PumpRecorder, canon

    cfg = EngineConfig(G=16, P=3, L=64, E=8, INGEST=8, use_kernels=True)
    skvs = []
    for dev in (card, "cpu"):
        d = EngineDriver(cfg, seed=13, device=dev)
        assert d.run_until_quiet_leaders(1000)
        skvs.append(BatchedShardKV(d))
    rec = PumpRecorder(*skvs)
    kernels.reset_launches()
    tickets = [[], []]
    for skv, ts in zip(skvs, tickets):
        _sharded_script(skv, ts, lambda tag: None)
    assert min(kernels.LAUNCHES.values()) > 0
    assert rec.check("sharded") > 0
    assert canon(tickets[0]) == canon(tickets[1])
    assert skvs[0].configs[-1].num == 3 and all(t.done for t in tickets[0])


def test_split_pair_on_the_card_equals_the_cpu(card):
    """A SplitShardKV pair at G=4 (owners [0, 1, 1]) on the card and on
    the CPU: join, writes, join, migration; each side equal to its
    counterpart after every pump."""
    from chip_smoke import _split_sides, _SplitRig
    from multiraft_tpu_torch.engine.split_shard import SplitShardKV
    from torch_parity import PumpRecorder

    cfg = EngineConfig(G=4, P=3, L=64, E=8, INGEST=8, use_kernels=True,
                       host_paced_compaction=True)
    owners = {g: [0, 1, 1] for g in range(cfg.G)}
    rigs = [_SplitRig(_split_sides(SplitShardKV, dev, owners, cfg, delay_on=1))
            for dev in (card, "cpu")]
    recs = [PumpRecorder(rigs[0].sides[i][0], rigs[1].sides[i][0]) for i in (0, 1)]
    for rig in rigs:
        rig.settle(cfg.G)
        rig.admin("join", {1: ["p1"]})
        for k in ("akey", "bkey", "ckey", "dkey"):
            rig.client_op("Put", k, f"v-{k}")
        rig.admin("join", {2: ["p2"]})
        rig.wait(lambda: rig.migrated([1, 2]), 3000, "migration")
        assert rig.client_op("Get", "ckey") == "v-ckey"
    for i, rec in enumerate(recs):
        assert rec.check(("split side", i)) > 0


def test_serve_kv_on_the_card(card, tmp_path):
    """``serve-kv`` with no ``--device`` serves from the card: one
    ``kv put`` and ``kv get`` through the command line at G=64."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "multiraft_tpu_torch", "serve-kv",
         "--groups", "64", "--data-dir", str(tmp_path / "serve")],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env, text=True,
    )
    try:
        line = proc.stdout.readline()
        assert line.startswith("ready "), (line, proc.poll())
        addr = f"127.0.0.1:{int(line.split()[1])}"

        def kv(*args):
            return subprocess.run(
                [sys.executable, "-m", "multiraft_tpu_torch", "kv", *args,
                 "--addr", addr],
                capture_output=True, text=True, env=env, timeout=120,
            )

        assert kv("put", "card", "h100").returncode == 0
        r = kv("get", "card")
        assert r.returncode == 0 and r.stdout.strip() == "h100", r.stderr
    finally:
        proc.kill()
        proc.wait()
        proc.stdout.close()


def test_serve_shardkv_on_the_card(card, tmp_path):
    """``serve-shardkv`` with no ``--device`` serves from the card: a
    bootstrap join, one ``kv --service EngineShardKV`` put and get at
    G=64, and SIGTERM exits 0 after its final checkpoint."""
    import os
    import signal
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "multiraft_tpu_torch", "serve-shardkv",
         "--groups", "64", "--join", "1,2,3", "--data-dir",
         str(tmp_path / "serve")],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env, text=True,
    )
    try:
        line = proc.stdout.readline()
        assert line.startswith("ready "), (line, proc.poll())
        addr = f"127.0.0.1:{int(line.split()[1])}"

        def kv(*args):
            return subprocess.run(
                [sys.executable, "-m", "multiraft_tpu_torch", "kv", *args,
                 "--addr", addr, "--service", "EngineShardKV"],
                capture_output=True, text=True, env=env, timeout=120,
            )

        assert kv("put", "card", "h100").returncode == 0
        r = kv("get", "card")
        assert r.returncode == 0 and r.stdout.strip() == "h100", r.stderr
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=240) == 0
        assert (tmp_path / "serve" / "engine.ckpt").exists()
    finally:
        proc.kill()
        proc.wait()
        proc.stdout.close()


def test_conformance_scenario_on_the_card_equals_the_cpu(card):
    """One conformance scenario with its engine half on the card: the
    stream equals the sim's (``run_both``) and the CPU engine's."""
    from multiraft_tpu_torch import conformance as conf

    sc = conf.SCENARIOS["cocktail"]
    stats = {}
    sim, on_card = conf.run_both(sc, seed=7, device=card, stats=stats)
    assert on_card == conf.run_engine(sc, seed=7, device="cpu")
    assert on_card == [sim, sim] and stats["ticks"] > 0


def test_bench_verify_on_the_card_equals_the_cpu(card):
    """The smoke's traced, faulted script at G=64 on the card and on the
    CPU: equal records and equal ``bench_verify`` results."""
    from chip_smoke import HEADLINE, traced_run, verify_run

    cfg = EngineConfig(use_kernels=True, **dict(HEADLINE, G=64))
    kernels.reset_launches()
    got = [verify_run(traced_run(cfg, dev, 60, 3, 8, 16), cfg) for dev in ("cuda", "cpu")]
    assert min(kernels.LAUNCHES.values()) >= 5 * 60
    for k in got[0]["recs"]:
        a, b = got[0]["recs"][k], got[1]["recs"][k]
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert got[0]["lat"] == got[1]["lat"] and got[0]["porc"] == got[1]["porc"]
    assert got[0]["porc"]["porcupine"] == "ok" and got[0]["lat"]["unaccounted"] == 0
    assert got[0]["lat"]["churned_groups"] > 0
