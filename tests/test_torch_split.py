"""The port's split replica groups (``multiraft_tpu_torch/engine/split.py``:
``SplitSpec``, ``SplitPeering``, ``SplitFrontierMixin``, ``SplitKV``)
against the reference.

Each engine-level scenario of ``tests/test_engine_split.py`` runs on a
pair of reference drivers (two "processes" in one interpreter, slabs
shuttled by hand) and on a pair of port drivers (``device="cpu"``) from
the same seeds.  After every pump of every side, the side's planes,
driver bookkeeping and service state (data, sessions, the peering's
payload candidates and staged lanes) are recorded, and every slab the
side extracts is kept; the port pair must go through the same records
and ship the same slabs, byte for byte in the reference's wire codec.
A mixed pair (side 0 from the port, side 1 from the reference,
exchanging slabs) must stay equal to the reference pair the same way.
"""

import types

import numpy as np
import pytest
import torch

import multiraft_tpu.engine.kv as RKV
import multiraft_tpu.engine.split as RS
import multiraft_tpu_torch.engine.kv as PKV
import multiraft_tpu_torch.engine.split as PS
from multiraft_tpu.engine.core import EngineConfig as JaxConfig
from multiraft_tpu.engine.host import EngineDriver as JaxDriver
from multiraft_tpu.transport import codec
from multiraft_tpu_torch.engine.core import EngineConfig
from multiraft_tpu_torch.engine.host import EngineDriver
from multiraft_tpu_torch.porcupine.types import OP_APPEND, OP_GET, OP_PUT
from torch_parity import PumpRecorder

# Small shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the host's cores.
torch.set_num_threads(1)

REF = types.SimpleNamespace(name="ref", split=RS, kv=RKV)
PORT = types.SimpleNamespace(name="port", split=PS, kv=PKV)


class Side:
    """One 'process' of one package: driver + SplitKV + peering."""

    def __init__(self, pkg, me, owners, G, seed, delay_elections=0):
        shape = dict(G=G, P=3, L=32, E=8, INGEST=8, host_paced_compaction=True)
        if pkg is REF:
            self.driver = JaxDriver(JaxConfig(**shape), seed=seed)
        else:
            self.driver = EngineDriver(EngineConfig(**shape), seed=seed, device="cpu")
        self.pkg = pkg
        self.kv = pkg.split.SplitKV(self.driver)
        self.peering = pkg.split.SplitPeering(
            self.driver, self.kv, pkg.split.SplitSpec(me=me, owners=owners))
        self.me = me
        self.alive = True
        if delay_elections:
            # Bias: let the OTHER side win the first elections.
            self.driver.state = self.driver.state._replace(
                elect_dl=self.driver.state.elect_dl + delay_elections)


class Pair:
    """Two sides and the hand shuttle of tests/test_engine_split.py, with
    every extracted slab kept (in the reference codec's bytes)."""

    def __init__(self, pkgs, owners, G=2, delay_on=None, delay=200):
        self.sides = [
            Side(pkgs[0], 0, owners, G, seed=11,
                 delay_elections=delay if delay_on == 0 else 0),
            Side(pkgs[1], 1, owners, G, seed=22,
                 delay_elections=delay if delay_on == 1 else 0),
        ]
        self.slabs = []
        self._cmd = 0

    def pump(self, rounds=1, cut=False):
        for _ in range(rounds):
            for side in self.sides:
                if not side.alive:
                    continue
                side.kv.pump(1)
                slabs = side.peering.extract()
                self.slabs.append((side.me, codec.encode(slabs)))
                if cut:
                    continue
                for proc, slab in slabs.items():
                    dst = self.sides[proc]
                    if dst.alive:
                        dst.peering.inject(slab)

    def total_leaders(self, g):
        return sum(int(s.driver.leaders_per_group()[g]) for s in self.sides if s.alive)

    def settle_leaders(self, G, max_rounds=400):
        for _ in range(max_rounds):
            self.pump(1)
            if all(self.total_leaders(g) == 1 for g in range(G)):
                return
        raise TimeoutError("split groups did not elect a single leader")

    def leader_side(self, g):
        for s in self.sides:
            if s.alive and s.kv.local_leader(g) is not None:
                return s
        return None

    def run_op(self, g, op, key, value="", max_rounds=500, cut=False):
        """Submit at the current leader's side (its package's KVOp), pump
        to commit; one session id per op keeps resubmits exactly-once."""
        self._cmd += 1
        for _ in range(max_rounds):
            side = self.leader_side(g)
            t = None if side is None else side.kv.submit_local(
                g, side.pkg.kv.KVOp(op=op, key=key, value=value,
                                    client_id=424242, command_id=self._cmd))
            if t is None:
                self.pump(1, cut=cut)
                continue
            for _ in range(max_rounds):
                self.pump(1, cut=cut)
                if t.done:
                    break
            if t.done and not t.failed:
                return t
        raise TimeoutError(f"op {op} {key!r} did not commit")


def elects_and_commits_across_processes(pair):
    pair.settle_leaders(G=2)
    for g in (0, 1):
        t = pair.run_op(g, OP_PUT, f"k{g}", f"v{g}")
        assert t.done and not t.failed
    for _ in range(100):
        pair.pump(1)
        if all(pair.sides[0].kv.data[g] == pair.sides[1].kv.data[g] for g in (0, 1)):
            break
    for g in (0, 1):
        for s in pair.sides:
            assert s.kv.data[g] == {f"k{g}": f"v{g}"}


def survives_minority_process_death(pair):
    pair.settle_leaders(G=1)
    assert pair.sides[0].kv.local_leader(0) is not None, "bias failed"
    acked = []
    for i in range(5):
        pair.run_op(0, OP_APPEND, "log", f"[{i}]")
        acked.append(f"[{i}]")
    pair.sides[0].alive = False
    for _ in range(600):
        pair.pump(1)
        if pair.sides[1].kv.local_leader(0) is not None:
            break
    assert pair.sides[1].kv.local_leader(0) is not None, "no failover leader"
    pair.run_op(0, OP_APPEND, "log", "[post]")
    assert pair.sides[1].kv.data[0]["log"] == "".join(acked) + "[post]"


def get_rides_the_log_after_failover(pair):
    pair.settle_leaders(G=1)
    pair.run_op(0, OP_PUT, "k", "pre-crash")
    pair.sides[0].alive = False
    for _ in range(600):
        pair.pump(1)
        if pair.sides[1].kv.local_leader(0) is not None:
            break
    assert pair.run_op(0, OP_GET, "k").value == "pre-crash"


def snapshot_catchup_after_partition(pair):
    pair.settle_leaders(G=1)
    assert pair.sides[0].kv.local_leader(0) is not None
    for i in range(40):
        pair.run_op(0, OP_PUT, f"k{i}", str(i), cut=True)
    st = pair.sides[0].driver.np_state()
    assert int(st["base"][0, pair.sides[0].kv.local_leader(0)]) > 0
    for _ in range(400):
        pair.pump(1)
        if pair.sides[1].kv.data[0] == pair.sides[0].kv.data[0]:
            break
    assert pair.sides[1].kv.data[0] == pair.sides[0].kv.data[0]
    assert pair.sides[1].kv.data[0]["k39"] == "39"


def submit_local_rejects_non_leader_process(pair):
    pair.settle_leaders(G=1)
    follower = (pair.sides[1] if pair.sides[0].kv.local_leader(0) is not None
                else pair.sides[0])
    assert follower.kv.submit_local(
        0, follower.pkg.kv.KVOp(op=OP_PUT, key="x", value="y")) is None


def lost_leadership_flushes_foreign_backlog(pair):
    pair.settle_leaders(G=1)
    s0 = pair.sides[0]
    assert s0.kv.local_leader(0) is not None
    t = s0.kv.submit_local(0, s0.pkg.kv.KVOp(op=OP_PUT, key="k", value="lost"))
    assert t is not None
    s0.alive = False
    for _ in range(600):
        pair.pump(1)
        if pair.sides[1].kv.local_leader(0) is not None:
            break
    s0.alive = True
    for _ in range(200):
        pair.pump(1)
        if t.done:
            break
    assert t.done, "orphaned backlog command never resolved"


SCENARIOS = [
    (elects_and_commits_across_processes, dict(owners={0: [0, 0, 1], 1: [1, 1, 0]})),
    (survives_minority_process_death, dict(owners={0: [0, 1, 1]}, G=1, delay_on=1)),
    (get_rides_the_log_after_failover, dict(owners={0: [0, 1, 1]}, G=1, delay_on=1)),
    (snapshot_catchup_after_partition, dict(owners={0: [0, 0, 1]}, G=1, delay_on=1)),
    (submit_local_rejects_non_leader_process, dict(owners={0: [0, 1, 1]}, G=1, delay_on=1)),
    (lost_leadership_flushes_foreign_backlog, dict(owners={0: [0, 1, 1]}, G=1, delay_on=1)),
]


def run_pairs(scenario, pkgs_b, **kw):
    """The scenario on a reference pair and on a pair of ``pkgs_b``; each
    side's pump records and the shipped slabs must be equal."""
    a, b = Pair((REF, REF), **kw), Pair(pkgs_b, **kw)
    recs = [PumpRecorder(a.sides[i].kv, b.sides[i].kv) for i in (0, 1)]
    for pair in (a, b):
        scenario(pair)
    for i, rec in enumerate(recs):
        assert rec.check((scenario.__name__, "side", i)) > 0
    assert len(a.slabs) == len(b.slabs)
    for n, (x, y) in enumerate(zip(a.slabs, b.slabs)):
        assert x == y, (scenario.__name__, "slab", n, "from side", x[0])
    return a, b


@pytest.mark.parametrize("scenario,kw", SCENARIOS, ids=[s.__name__ for s, _ in SCENARIOS])
def test_split_scenario_matches_reference_pump_by_pump(scenario, kw):
    _, b = run_pairs(scenario, (PORT, PORT), **kw)
    assert sum(len(s) > 2 for _, s in b.slabs) > 0


@pytest.mark.parametrize("scenario,kw", SCENARIOS[:2], ids=[s.__name__ for s, _ in SCENARIOS[:2]])
def test_mixed_pair_matches_reference_pair(scenario, kw):
    """Side 0 from the port, side 1 from the reference, exchanging slabs:
    both sides stay equal to a pair of reference drivers, and every slab
    the port ships is the one the reference ships."""
    run_pairs(scenario, (PORT, REF), **kw)


def test_extract_python_types_and_staged_merge_are_the_references():
    """A slab is lists, ints and bools (no numpy scalar reaches the
    wire); the staged merge writes the inbox out of place."""
    pair = Pair((PORT, PORT), owners={0: [0, 1, 1]}, G=1)
    pair.settle_leaders(G=1)
    side = pair.sides[1]
    old = side.driver.inbox
    slab = pair.sides[0].peering.extract()
    for msg in [m for s in slab.values() for m in s["msgs"]]:
        g, src, dst, prefix, fields = msg
        assert type(g) is int and type(prefix) is str
        for v in fields.values():
            assert type(v) in (int, bool, list), type(v)
            if isinstance(v, list):
                assert all(type(e) is int for e in v)
    if 1 in slab:
        side.peering.inject(slab[1])
        held = {f: getattr(old, f).clone() for f in old._fields}
        side.peering.flush_staged()
        assert side.driver.inbox is not old
        for f in old._fields:
            assert torch.equal(getattr(old, f), held[f]), f
    alive = side.driver.state.alive
    assert not bool(alive[0, 0]) and bool(alive[0, 1]) and bool(alive[0, 2])


def test_split_requires_host_paced_compaction():
    d = EngineDriver(EngineConfig(G=2, L=32, E=8, INGEST=8), seed=1, device="cpu")
    kv = PS.SplitKV(d)
    with pytest.raises(ValueError, match="host_paced_compaction"):
        PS.SplitPeering(d, kv, PS.SplitSpec(me=0, owners={0: [0, 1, 1]}))
    d = EngineDriver(EngineConfig(G=2, L=32, E=8, INGEST=8, host_paced_compaction=True),
                     seed=1, device="cpu")
    with pytest.raises(ValueError, match="3 slots"):
        PS.SplitPeering(d, PS.SplitKV(d), PS.SplitSpec(me=0, owners={0: [0, 1]}))
    with pytest.raises(ValueError, match="outside engine G"):
        PS.SplitPeering(d, PS.SplitKV(d), PS.SplitSpec(me=0, owners={5: [0, 1, 1]}))
    spec = PS.SplitSpec(me=1, owners={0: [0, 1, 1], 1: [2, 1, 0]})
    assert (spec.owned_slots(1), spec.remote_slots(1), spec.peer_procs()) == ([1], [0, 2], [0, 2])


def test_paced_applied_equals_the_reference_formula():
    """``_pre_sweep`` raises ``applied`` to the host frontier clipped into
    [base, commit], out of place."""
    rng = np.random.default_rng(3)
    d = EngineDriver(EngineConfig(G=6, L=32, E=8, INGEST=8, host_paced_compaction=True),
                     seed=1, device="cpu")
    kv = PS.SplitKV(d)
    PS.SplitPeering(d, kv, PS.SplitSpec(me=0, owners={0: [0, 1, 1]}))
    base = torch.from_numpy(rng.integers(0, 20, (6, 3)).astype(np.int32))
    commit = base + torch.from_numpy(rng.integers(0, 20, (6, 3)).astype(np.int32))
    applied = base + torch.from_numpy(rng.integers(0, 5, (6, 3)).astype(np.int32))
    d.state = d.state._replace(base=base, commit=commit, applied=applied)
    kv.applied_upto = rng.integers(0, 45, 6).tolist()
    kv._pre_sweep()
    up = np.asarray(kv.applied_upto, np.int32)[:, None]
    want = np.maximum(applied.numpy(), np.minimum(np.maximum(up, base.numpy()), commit.numpy()))
    assert d.state.applied is not applied
    assert np.array_equal(d.state.applied.numpy(), want)
