"""The port's per-replica Raft stack against the JAX package's, on the CPU.

Each scenario of ``tests/test_raft_{election,replication,persistence,
snapshot,prevote}.py`` runs through both packages' ``RaftHarness`` from
one seed.  Every value is an int, a command or a virtual time, so the
two runs must agree exactly: each server's term, vote, log
``(index, term, command)``, commit index and applied stream, the
network's counts and bytes, and ``sched.now``.
"""

import pytest

import multiraft_tpu.harness.raft_harness as ref_harness
import multiraft_tpu_torch.harness.raft_harness as port_harness
from multiraft_tpu.raft.node import ELECTION_TIMEOUT as REF_ELECTION
from multiraft_tpu_torch.raft.node import ELECTION_TIMEOUT

SNAPSHOT_INTERVAL = port_harness.SNAPSHOT_INTERVAL


def world(h) -> dict:
    """Everything a seeded run leaves behind, as plain values."""
    servers = []
    for i, r in enumerate(h.rafts):
        if r is None:
            servers.append(None)
            continue
        servers.append({
            "term": r.current_term,
            "vote": r.voted_for,
            "role": int(r.role),
            "log": [(e.index, e.term, e.command) for e in r.log.entries],
            "commit": r.commit_index,
            "applied": r.last_applied,
            "stream": sorted(h.logs[i].items()),
            "persisted": (len(r.persister.read_raft_state()),
                          len(r.persister.read_snapshot())),
        })
    return {
        "servers": servers,
        "connected": list(h.connected),
        "now": h.sched.now,
        "rpcs": h.rpc_total(),
        "bytes": h.bytes_total(),
        "per_server": [h.rpc_count(i) for i in range(h.n)],
        "apply_err": h.apply_err,
    }


def both(scenario, *args) -> dict:
    """Run ``scenario(RaftHarness, *args)`` in each package; the worlds
    must be equal.  Returns the port's."""
    out = []
    for mod in (ref_harness, port_harness):
        h = scenario(mod.RaftHarness, *args)
        out.append(world(h))
        h.cleanup()
    assert out[1] == out[0]
    return out[1]


# -- 2A election -----------------------------------------------------------


def initial_election(H):
    cfg = H(3, seed=1)
    cfg.check_one_leader()
    cfg.sched.run_for(0.05)
    term1 = cfg.check_terms()
    cfg.sched.run_for(2 * ELECTION_TIMEOUT[1])
    assert cfg.check_terms() == term1
    cfg.check_one_leader()
    return cfg


def reelection(H):
    cfg = H(3, seed=2)
    leader1 = cfg.check_one_leader()
    cfg.disconnect(leader1)
    cfg.check_one_leader()
    cfg.connect(leader1)
    leader2 = cfg.check_one_leader()
    cfg.disconnect(leader2)
    cfg.disconnect((leader2 + 1) % 3)
    cfg.sched.run_for(2 * ELECTION_TIMEOUT[1])
    cfg.check_no_leader()
    cfg.connect((leader2 + 1) % 3)
    cfg.check_one_leader()
    cfg.connect(leader2)
    cfg.check_one_leader()
    return cfg


def many_elections(H):
    cfg = H(7, seed=3)
    cfg.check_one_leader()
    for _ in range(10):
        picks = [cfg.rng.randrange(7) for _ in range(3)]
        for i in picks:
            cfg.disconnect(i)
        cfg.check_one_leader()
        for i in picks:
            cfg.connect(i)
    cfg.check_one_leader()
    return cfg


# -- 2B replication --------------------------------------------------------


def basic_agree(H):
    cfg = H(3, seed=10)
    for index in range(1, 4):
        assert cfg.one(index * 100, 3, retry=False) == index
    return cfg


def rpc_bytes(H):
    cfg = H(3, seed=11)
    cfg.one(99, 3, retry=False)
    for index in range(2, 12):
        assert cfg.one("x" * 5000, 3, retry=False) == index
    return cfg


def fail_agree(H):
    cfg = H(3, seed=12)
    cfg.one(101, 3, retry=False)
    leader = cfg.check_one_leader()
    cfg.disconnect((leader + 1) % 3)
    cfg.one(102, 2, retry=False)
    cfg.one(103, 2, retry=False)
    cfg.sched.run_for(ELECTION_TIMEOUT[1])
    cfg.one(104, 2, retry=False)
    cfg.connect((leader + 1) % 3)
    cfg.one(106, 3, retry=True)
    cfg.sched.run_for(ELECTION_TIMEOUT[1])
    cfg.one(107, 3, retry=True)
    return cfg


def fail_no_agree(H):
    cfg = H(5, seed=13)
    cfg.one(10, 5, retry=False)
    leader = cfg.check_one_leader()
    for k in (1, 2, 3):
        cfg.disconnect((leader + k) % 5)
    index, _, ok = cfg.rafts[leader].start(20)
    assert ok and index == 2
    cfg.sched.run_for(2 * ELECTION_TIMEOUT[1])
    n, _ = cfg.n_committed(index)
    assert n == 0
    for k in (1, 2, 3):
        cfg.connect((leader + k) % 5)
    cfg.one(1000, 5, retry=True)
    return cfg


def backup(H):
    cfg = H(5, seed=16)
    rng = cfg.rng
    cfg.one(rng.randrange(1 << 30), 5, retry=True)
    leader1 = cfg.check_one_leader()
    for k in (2, 3, 4):
        cfg.disconnect((leader1 + k) % 5)
    for _ in range(50):
        cfg.rafts[leader1].start(rng.randrange(1 << 30))
    cfg.sched.run_for(ELECTION_TIMEOUT[0] / 2)
    cfg.disconnect(leader1)
    cfg.disconnect((leader1 + 1) % 5)
    for k in (2, 3, 4):
        cfg.connect((leader1 + k) % 5)
    for _ in range(50):
        cfg.one(rng.randrange(1 << 30), 3, retry=True)
    leader2 = cfg.check_one_leader()
    other = (leader1 + 2) % 5
    if leader2 == other:
        other = (leader2 + 1) % 5
    cfg.disconnect(other)
    for _ in range(50):
        cfg.rafts[leader2].start(rng.randrange(1 << 30))
    cfg.sched.run_for(ELECTION_TIMEOUT[0] / 2)
    for i in range(5):
        cfg.disconnect(i)
    cfg.connect(leader1)
    cfg.connect((leader1 + 1) % 5)
    cfg.connect(other)
    for _ in range(50):
        cfg.one(rng.randrange(1 << 30), 3, retry=True)
    for i in range(5):
        cfg.connect(i)
    cfg.one(rng.randrange(1 << 30), 5, retry=True)
    return cfg


def concurrent_starts(H):
    cfg = H(3, seed=14)
    leader = cfg.check_one_leader()
    _, term, _ = cfg.rafts[leader].start(1)
    idxs = [cfg.rafts[leader].start(100 + i)[0] for i in range(5)]
    for ix in idxs:
        assert cfg.wait(ix, 3, term) != -1
    return cfg


# -- 2C persistence --------------------------------------------------------


def persist1(H):
    cfg = H(3, seed=20)
    cfg.one(11, 3, retry=True)
    for i in range(3):
        cfg.start1(i)
    for i in range(3):
        cfg.disconnect(i)
        cfg.connect(i)
    cfg.one(12, 3, retry=True)
    leader1 = cfg.check_one_leader()
    cfg.disconnect(leader1)
    cfg.start1(leader1)
    cfg.connect(leader1)
    cfg.one(13, 3, retry=True)
    leader2 = cfg.check_one_leader()
    cfg.disconnect(leader2)
    cfg.one(14, 2, retry=True)
    cfg.start1(leader2)
    cfg.connect(leader2)
    cfg.wait(4, 3, -1)
    i3 = (cfg.check_one_leader() + 1) % 3
    cfg.disconnect(i3)
    cfg.one(15, 2, retry=True)
    cfg.start1(i3)
    cfg.connect(i3)
    cfg.one(16, 3, retry=True)
    return cfg


def persist3(H):
    cfg = H(3, seed=22)
    cfg.one(101, 3, retry=True)
    leader = cfg.check_one_leader()
    cfg.disconnect((leader + 2) % 3)
    cfg.one(102, 2, retry=True)
    cfg.crash1(leader)
    cfg.connect((leader + 2) % 3)
    cfg.one(103, 2, retry=True)
    cfg.start1(leader)
    cfg.connect(leader)
    cfg.one(104, 3, retry=True)
    return cfg


def figure8(H, unreliable, iters, seed):
    cfg = H(5, unreliable=unreliable, seed=seed)
    if unreliable:
        cfg.net.set_long_reordering(True)
    rng = cfg.rng
    cfg.one(rng.randrange(1 << 30), 1, retry=True)
    nup = 5
    for _ in range(iters):
        leader = -1
        for i in range(5):
            if cfg.rafts[i] is not None:
                _, _, ok = cfg.rafts[i].start(rng.randrange(1 << 30))
                if ok and cfg.connected[i]:
                    leader = i
        if rng.randrange(1000) < 100:
            cfg.sched.run_for(rng.uniform(0, ELECTION_TIMEOUT[0] / 2))
        else:
            cfg.sched.run_for(rng.uniform(0, 0.013))
        if leader != -1 and (rng.randrange(1000) < 500 or not unreliable):
            cfg.crash1(leader)
            nup -= 1
        if nup < 3:
            s = rng.randrange(5)
            if cfg.rafts[s] is None:
                cfg.start1(s)
                cfg.connect(s)
                nup += 1
    for i in range(5):
        if cfg.rafts[i] is None:
            cfg.start1(i)
        cfg.connect(i)
    cfg.one(rng.randrange(1 << 30), 5, retry=True)
    return cfg


def unreliable_agree(H):
    cfg = H(5, unreliable=True, seed=25)
    for it in range(1, 20):
        for j in range(4):
            cfg.one(100 * it + j, 1, retry=True)
        cfg.one(it, 1, retry=True)
    cfg.net.set_reliable(True)
    cfg.sched.run_for(1.0)
    cfg.one(100, 5, retry=True)
    return cfg


def churn(H, unreliable, seed):
    cfg = H(5, unreliable=unreliable, seed=seed)
    rng = cfg.rng
    stop = [False]

    def client():
        while not stop[0]:
            x = rng.randrange(1 << 30)
            for i in range(5):
                rf = cfg.rafts[i]
                if rf is not None and rf.start(x)[2]:
                    break
            yield rng.uniform(0.01, 0.09)

    clients = [cfg.sched.spawn(client()) for _ in range(3)]
    t_end = cfg.sched.now + 7.0
    while cfg.sched.now < t_end:
        action, victim = rng.randrange(4), rng.randrange(5)
        if action == 0 and cfg.connected[victim]:
            cfg.disconnect(victim)
        elif action == 1 and cfg.rafts[victim] is not None:
            cfg.connect(victim)
        elif action == 2 and cfg.rafts[victim] is not None:
            cfg.crash1(victim)
        elif action == 3 and cfg.rafts[victim] is None:
            cfg.start1(victim)
            cfg.connect(victim)
        cfg.sched.run_for(rng.uniform(0.05, 0.2))
    for i in range(5):
        if cfg.rafts[i] is None:
            cfg.start1(i)
        cfg.connect(i)
    cfg.net.set_reliable(True)
    stop[0] = True
    cfg.sched.run_for(0.5)
    assert all(c.done for c in clients)
    cfg.one(rng.randrange(1 << 30), 5, retry=True)
    return cfg


# -- 2D snapshots ----------------------------------------------------------


def snapcommon(H, disconnect, reliable, crash, seed, iters=12):
    cfg = H(3, unreliable=not reliable, snapshot=True, seed=seed)
    rng = cfg.rng
    cfg.one(rng.randrange(1 << 30), 3, retry=True)
    leader1 = cfg.check_one_leader()
    for i in range(iters):
        victim, sender = (leader1 + 1) % 3, leader1
        if i % 3 == 1:
            sender, victim = (leader1 + 1) % 3, leader1
        if disconnect:
            cfg.disconnect(victim)
            cfg.one(rng.randrange(1 << 30), 2, retry=True)
        if crash:
            cfg.crash1(victim)
            cfg.one(rng.randrange(1 << 30), 2, retry=True)
        for _ in range(SNAPSHOT_INTERVAL // 2 + rng.randrange(SNAPSHOT_INTERVAL)):
            rf = cfg.rafts[sender]
            if rf is not None:
                rf.start(rng.randrange(1 << 30))
        n = 2 if (disconnect or crash) else 3
        cfg.one(rng.randrange(1 << 30), n, retry=True)
        if disconnect:
            cfg.connect(victim)
            cfg.one(rng.randrange(1 << 30), 3, retry=True)
            leader1 = cfg.check_one_leader()
        if crash:
            cfg.start1(victim)
            cfg.connect(victim)
            cfg.one(rng.randrange(1 << 30), 3, retry=True)
            leader1 = cfg.check_one_leader()
    return cfg


def snapshot_all_crash(H):
    cfg = H(3, snapshot=True, seed=35)
    rng = cfg.rng
    cfg.one(rng.randrange(1 << 30), 3, retry=True)
    for _ in range(3):
        for _ in range(SNAPSHOT_INTERVAL // 2 + rng.randrange(SNAPSHOT_INTERVAL)):
            cfg.one(rng.randrange(1 << 30), 3, retry=True)
        index1 = cfg.one(rng.randrange(1 << 30), 3, retry=True)
        for i in range(3):
            cfg.crash1(i)
        for i in range(3):
            cfg.start1(i)
            cfg.connect(i)
        assert cfg.one(rng.randrange(1 << 30), 3, retry=True) >= index1 + 1
    return cfg


# -- prevote ---------------------------------------------------------------


def prevote_partitioned_follower(H):
    h = H(3, seed=61, prevote=True)
    leader = h.check_one_leader()
    term0 = h.check_terms()
    victim = (leader + 1) % 3
    h.disconnect(victim)
    for i in range(10):
        h.one(f"mid{i}", expected_servers=2, retry=False)
        h.sched.run_for(0.6)
    assert h.rafts[victim].current_term == term0
    h.connect(victim)
    h.sched.run_for(2.0)
    assert h.check_one_leader() == leader
    h.one("after", expected_servers=3, retry=False)
    return h


def prevote_leader_death(H):
    h = H(3, seed=62, prevote=True)
    leader = h.check_one_leader()
    h.one("a", expected_servers=3, retry=False)
    h.crash1(leader)
    assert h.check_one_leader() != leader
    h.one("b", expected_servers=2, retry=True)
    h.start1(leader)
    h.connect(leader)
    h.one("c", expected_servers=3, retry=True)
    return h


def prevote_unreliable(H):
    h = H(5, unreliable=True, seed=63, prevote=True)
    for i in range(8):
        h.one(f"u{i}", expected_servers=1, retry=True)
    h.net.set_reliable(True)
    h.sched.run_for(1.0)
    h.one("final", expected_servers=5, retry=True)
    return h


CASES = {
    "initial_election": (initial_election,),
    "reelection": (reelection,),
    "many_elections": (many_elections,),
    "basic_agree": (basic_agree,),
    "rpc_bytes": (rpc_bytes,),
    "fail_agree": (fail_agree,),
    "fail_no_agree": (fail_no_agree,),
    "concurrent_starts": (concurrent_starts,),
    "backup": (backup,),
    "persist1": (persist1,),
    "persist3": (persist3,),
    "figure8": (figure8, False, 60, 23),
    "figure8_unreliable": (figure8, True, 60, 24),
    "unreliable_agree": (unreliable_agree,),
    "churn": (churn, False, 26),
    "churn_unreliable": (churn, True, 27),
    "snapshot_basic": (snapcommon, False, True, False, 30),
    "snapshot_install": (snapcommon, True, True, False, 31),
    "snapshot_install_unreliable": (snapcommon, True, False, False, 32),
    "snapshot_install_crash": (snapcommon, False, True, True, 33),
    "snapshot_install_unreliable_crash": (snapcommon, False, False, True, 34),
    "snapshot_all_crash": (snapshot_all_crash,),
    "prevote_partitioned_follower": (prevote_partitioned_follower,),
    "prevote_leader_death": (prevote_leader_death,),
    "prevote_unreliable": (prevote_unreliable,),
}


def test_timing_constants_match():
    assert ELECTION_TIMEOUT == REF_ELECTION
    assert port_harness.SNAPSHOT_INTERVAL == ref_harness.SNAPSHOT_INTERVAL
    assert port_harness.MAX_LOG_SIZE == ref_harness.MAX_LOG_SIZE


@pytest.mark.parametrize("case", sorted(CASES))
def test_raft_scenario_matches_reference(case):
    fn, *args = CASES[case]
    w = both(fn, *args)
    live = [s for s in w["servers"] if s is not None]
    assert live and all(s["term"] > 0 for s in live)
    assert w["apply_err"] is None
