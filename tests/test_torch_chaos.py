"""The port's fault surface in lockstep with the reference: reorder chaos
(``set_reorder``/``_apply_reorder``), crash-restart (``restart_replica``),
slot reset (``reset_replica``) and the invariant monitor.

Each test drives the fault script of ``tests/test_engine_fuzz.py``'s
``run_fuzz`` into a reference ``EngineDriver`` (Pallas kernels under the
interpreter) and a port ``EngineDriver`` on the CPU in lockstep.  After
every tick every state and inbox plane, the reorder delay queue, the
numpy reorder RNG's state, the backlog, the payload bindings and the
commit total must be equal, bit for bit, and the port's
``InvariantMonitor`` must pass.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import _pick_replicas
from multiraft_tpu_torch.bench import full_ring_stalls
from multiraft_tpu.engine.core import EngineConfig as JaxConfig
from multiraft_tpu.engine.host import EngineDriver as JaxDriver
from multiraft_tpu.engine.invariants import InvariantMonitor as JaxMonitor
from multiraft_tpu_torch import convert
from multiraft_tpu_torch.engine.core import LEADER, EngineConfig
from multiraft_tpu_torch.engine.host import EngineDriver
from multiraft_tpu_torch.engine.invariants import InvariantMonitor
from torch_parity import same_delayed

# Small shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the host's cores.
torch.set_num_threads(1)

SHAPE = dict(L=32, E=4, INGEST=4)


def pair(G, P, seed, kernels=True):
    """A reference and a port driver from one seed: the kernel path
    (Pallas interpreter / the kernels' plain versions) or, for
    membership, the plain path."""
    ref = JaxDriver(
        JaxConfig(G=G, P=P, use_pallas=kernels, pallas_interpret=kernels,
                  **SHAPE),
        seed=seed,
    )
    port = EngineDriver(
        EngineConfig(G=G, P=P, use_kernels=kernels, **SHAPE), seed=seed,
        device="cpu",
    )
    return ref, port


def assert_same_world(ref, port, where) -> None:
    a, b = ref.np_state(), port.np_state()
    for k in a:
        assert a[k].dtype == b[k].dtype, (where, k)
        assert np.array_equal(a[k], b[k]), (where, "state", k)
    ib = convert.mailbox_to_numpy(port.inbox)
    for k, v in ref.inbox._asdict().items():
        assert np.array_equal(np.asarray(v), ib[k]), (where, "inbox", k)
    assert ref.tick == port.tick, where
    assert same_delayed(ref._delayed, port._delayed), (where, "delayed")
    assert (ref._np_rng.bit_generator.state
            == port._np_rng.bit_generator.state), (where, "np_rng")
    assert ref.backlog.tolist() == port.backlog.tolist(), where
    assert ref.payloads == port.payloads, where
    assert ref.commits_total == port.commits_total, where


def lockstep_fuzz(seed, G=4, P=3, ticks=350, p_crash=0.02, p_restart=0.25,
                  drop_choices=(0.0, 0.0, 0.1, 0.3), reorder=0.0):
    """``run_fuzz``'s fault script, every call made on both drivers."""
    rng = np.random.default_rng(seed)
    ref, port = pair(G, P, seed)
    both = (ref, port)
    if reorder:
        for d in both:
            d.set_reorder(reorder, 2, 10)
    mon = InvariantMonitor(port)
    dead, cut = set(), set()
    held = 0
    for t in range(ticks):
        if rng.random() < p_crash:
            g, p = int(rng.integers(G)), int(rng.integers(P))
            if (g, p) not in dead:
                for d in both:
                    d.set_alive(g, p, False)
                dead.add((g, p))
        if dead and rng.random() < p_restart:
            g, p = list(dead)[int(rng.integers(len(dead)))]
            for d in both:
                d.restart_replica(g, p)
            mon.note_restart(g, p)
            dead.discard((g, p))
        if rng.random() < p_crash:
            g, p = int(rng.integers(G)), int(rng.integers(P))
            if (g, p) not in cut:
                for d in both:
                    d.partition_replica(g, p, False)
                cut.add((g, p))
        if cut and rng.random() < p_restart:
            g, p = list(cut)[int(rng.integers(len(cut)))]
            for d in both:
                d.partition_replica(g, p, True)
            cut.discard((g, p))
        if t % 50 == 0:
            drop = float(rng.choice(drop_choices))
            for d in both:
                d.drop_prob = drop
        if rng.random() < 0.5:
            g = int(rng.integers(G))
            for d in both:
                d.start(g, f"cmd-{seed}-{t}-{g}")
        for d in both:
            d.step()
        mon.observe()
        held = max(held, len(port._delayed))
        assert_same_world(ref, port, t)
    return port, held


@pytest.mark.parametrize("reorder", [0.0, 2.0 / 3.0], ids=["plain", "reorder"])
def test_fuzz_script_in_lockstep(reorder):
    port, held = lockstep_fuzz(seed=23, ticks=300, reorder=reorder)
    assert port.commits_total > 0
    if reorder:
        assert held > 0, "the reorder run never held a message"


def test_fuzz_five_peers_reorder_in_lockstep():
    """P=5 with heavier faults and reorder: restarts prune held messages
    of the restarted replica on both sides alike."""
    port, held = lockstep_fuzz(seed=77, P=5, G=3, ticks=200, p_crash=0.05,
                               reorder=0.5, drop_choices=(0.0, 0.1, 0.2))
    assert held > 0 and port.commits_total > 0


def test_set_reorder_refuses_bad_parameters():
    ref, port = pair(1, 3, 0)
    for bad in ((1.5, 2, 8), (0.5, 0, 8), (0.5, 5, 4)):
        for d in (ref, port):
            with pytest.raises(ValueError, match="bad parameters"):
                d.set_reorder(*bad)


def test_reorder_holds_back_fused_stepping_until_drained():
    """A driver with reorder on or messages held steps serially; once
    reorder is off and the queue drains, fused stepping resumes, and the
    two drivers stay equal throughout."""
    ref, port = pair(4, 3, 7)
    ref._pipeline_on = port._pipeline_on = True
    for d in (ref, port):
        d.set_reorder(2.0 / 3.0, 3, 12)
    for t in range(60):
        for d in (ref, port):
            if t % 3 == 0:
                d.start(t % 4, f"cmd-{t}")
            d.step()
    assert not port.fused_eligible()
    for d in (ref, port):
        d.set_reorder(0.0)
    assert port._delayed and not port.fused_eligible()
    for _ in range(15):
        for d in (ref, port):
            d.step(4)
        assert_same_world(ref, port, "drain")
    assert not port._delayed and port.fused_eligible()


def test_monitors_raise_the_same_election_safety_violation():
    """Plant a second leader in the leader's term by state surgery: both
    packages' monitors raise, with the same diagnosis."""
    ref, port = pair(2, 3, 5)
    jmon, mon = JaxMonitor(ref), InvariantMonitor(port)
    assert ref.run_until_quiet_leaders(300) and port.run_until_quiet_leaders(300)
    jmon.observe()
    mon.observe()
    lead = port.leader_of(0)
    assert lead == ref.leader_of(0)
    other = (lead + 1) % 3
    st = port.np_state()
    role, term = st["role"].copy(), st["term"].copy()
    role[0, other] = LEADER
    term[0, other] = term[0, lead]
    port.state = port.state._replace(
        role=torch.from_numpy(role), term=torch.from_numpy(term)
    )
    ref.state = ref.state._replace(role=jnp.asarray(role), term=jnp.asarray(term))
    msgs = []
    for m in (jmon, mon):
        with pytest.raises(AssertionError, match="election safety") as e:
            m.observe()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_restart_and_reset_write_out_of_place():
    """The planes a caller held before a restart or a reset are not
    written: both ops replace planes, never write them in place."""
    _, port = pair(2, 3, 9)
    port.step(40)
    held = {k: v.clone() for k, v in port.state._asdict().items()}
    before = port.state
    port.restart_replica(0, 1)
    port.reset_replica(1, 2)
    for k, v in before._asdict().items():
        assert torch.equal(v, held[k]), k


def _settle_config(ref, port, g, target, max_ticks=400) -> bool:
    """Step both until group g's config has collapsed to ``target``
    (joint exited, old == new) at its leader, comparing as it goes."""
    for t in range(max_ticks):
        ref.step()
        port.step()
        if t % 10 == 0:
            assert_same_world(ref, port, ("settle", t))
        lead = port.leader_of(g)
        assert lead == ref.leader_of(g)
        if lead is None:
            continue
        c = port.config_of(g)
        assert c == ref.config_of(g)
        if not c["joint"] and c["voters_old"] == c["voters_new"] == target:
            return True
    return False


def test_reset_replica_clears_stale_cross_columns_in_lockstep():
    """``tests/test_membership.py``'s stale cross-column scenario on both
    drivers: plant the old incarnation's votes, prevotes and match
    entries, reset the slot, then re-add it as a learner and promote it;
    the worlds stay equal at every step."""
    ref, port = pair(1, 4, 13, kernels=False)
    both = (ref, port)
    assert ref.run_until_quiet_leaders(400) and port.run_until_quiet_leaders(400)
    for d in both:
        for i in range(5):
            d.start(0, f"x{i}")
        d.step(80)
    assert_same_world(ref, port, "loaded")
    victim = (port.leader_of(0) + 1) % 4
    rest = [q for q in range(4) if q != victim]
    assert ref.begin_joint(0, rest) == port.begin_joint(0, rest)
    assert _settle_config(ref, port, 0, rest)
    st = port.np_state()
    planted = dict(votes=st["votes"].copy(), pre_votes=st["pre_votes"].copy(),
                   match_idx=st["match_idx"].copy(),
                   voted_for=st["voted_for"].copy())
    planted["votes"][0, :, victim] = True
    planted["pre_votes"][0, :, victim] = True
    planted["match_idx"][0, :, victim] = 99
    planted["voted_for"][0, victim] = 2
    ref.state = ref.state._replace(**{k: jnp.asarray(v) for k, v in planted.items()})
    port.state = port.state._replace(
        **{k: torch.from_numpy(v.copy()) for k, v in planted.items()}
    )
    for d in both:
        d.set_alive(0, victim, False)
        d.reset_replica(0, victim)
    assert_same_world(ref, port, "reset")
    st = port.np_state()
    assert not st["votes"][0, :, victim].any()
    assert (st["match_idx"][0, :, victim] == 0).all()
    assert st["last_ack"][0, victim, victim] == st["tick_no"]
    for d in both:
        d.add_learner(0, victim)
    assert_same_world(ref, port, "learner")
    assert ref.run_until_quiet_leaders(400) and port.run_until_quiet_leaders(400)
    assert ref.begin_joint(0, [0, 1, 2, 3]) == port.begin_joint(0, [0, 1, 2, 3])
    assert _settle_config(ref, port, 0, [0, 1, 2, 3])
    assert_same_world(ref, port, "rejoined")
    port.check_log_matching(0)


def test_full_ring_stall_in_lockstep():
    """The liveness fault of the reference engine that ``chip_smoke.py``'s
    fault phase reports instead of failing on (ROADMAP C): under a
    firehose, a leader elected with the ring above its commit full of
    older-term entries can never commit again.  The smoke's own fault
    script (1% drops, crashes and cuts at tick 50, restarts and heals at
    tick 100) at a tight margin, L - 2 - E = 26 ring slots with INGEST=8:
    the reference reaches the stall, the port reaches it on the same tick
    with every plane equal, ``bench.full_ring_stalls`` flags the same groups
    in both, a flagged group's commit never moves again, and every other
    group commits after the heal, the smoke's check."""
    shape = dict(G=16, P=3, L=32, E=4, INGEST=8)
    ref = JaxDriver(
        JaxConfig(use_pallas=True, pallas_interpret=True, **shape), seed=4
    )
    port = EngineDriver(
        EngineConfig(use_kernels=True, **shape), seed=4, device="cpu"
    )
    both = (ref, port)
    for d in both:
        assert d.run_until_quiet_leaders(500)
        d.start_bulk(np.full(shape["G"], 8 * 600, np.int64))
        d.drop_prob = 0.01
    crashed, cut = _pick_replicas(np.random.default_rng(4), shape["G"], 3, 8)
    frozen = {}  # group -> its commit when first flagged
    for t in range(250):
        for d in both:
            if t == 50:
                for g, p in crashed:
                    d.set_alive(g, p, False)
                for g, p in cut:
                    d.partition_replica(g, p, False)
            if t == 100:
                for g, p in crashed:
                    d.restart_replica(g, p)
                for g, p in cut:
                    d.partition_replica(g, p, True)
        if t == 100:
            at_heal = port.np_state()["commit"].max(axis=1)
        for d in both:
            d.step()
        assert_same_world(ref, port, t)
        st = ref.np_state()
        flagged = full_ring_stalls(st, ref.cfg)
        assert np.array_equal(flagged, full_ring_stalls(port.np_state(), port.cfg)), t
        commit = st["commit"].max(axis=1)
        for g in np.nonzero(flagged)[0].tolist():
            frozen.setdefault(g, int(commit[g]))
        for g, c in frozen.items():
            assert commit[g] == c, (t, g, "a flagged group committed again")
    assert frozen, "the script never reached the full-ring stall"
    assert flagged[list(frozen)].all()
    advanced = commit > at_heal
    assert (advanced | flagged).all()
