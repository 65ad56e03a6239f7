"""Replica moves by joint consensus at a small size on the CPU: the
voter set that ``EngineConfig.replicas`` seeds, the batched moves of
``engine/membership.py`` against the reference's per-group admin ops,
the ``replica_moves`` event module's two sides, and the ``j3`` cell's
check (``cellbench/reference/joint.py``), its control and a planted
fault, its failure count and the moves' counters.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cellbench import harness, manifest, traffic
from cellbench.reference import joint
from cellbench.reference import prng as rprng
from multiraft_tpu.engine.core import EngineConfig as JaxConfig
from multiraft_tpu.engine.host import EngineDriver as JaxDriver
from multiraft_tpu_torch.engine import core, membership
from multiraft_tpu_torch.engine.core import LEADER, EngineConfig
from multiraft_tpu_torch.engine.host import EngineDriver
from tests.test_torch_chaos import assert_same_world

# Small shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the host's cores.
torch.set_num_threads(1)

TIMING = dict(HB_TICKS=2, ELECT_MIN=10, ELECT_MAX=20, prevote=True, check_quorum=True,
              membership=True)
SHAPE = dict(G=16, P=4, L=64, E=8, INGEST=8, **TIMING)
CELL = "j3.uniform_moves"
SMALL = {"G": 64, "L": 64, "E": 8, "INGEST": 8}


def drivers(seed):
    """A reference ``EngineDriver`` seeded by ``seed_config([0, 1, 2])``
    and a port one whose ``EngineConfig.replicas`` is 3."""
    ref = JaxDriver(JaxConfig(use_pallas=False, **SHAPE), seed=seed)
    ref.seed_config([0, 1, 2])
    port = EngineDriver(EngineConfig(replicas=3, **SHAPE), seed=seed, device="cpu")
    return ref, port


def step_both(ref, port, n, load=3):
    for _ in range(n):
        for d in (ref, port):
            d.start_bulk(np.full(d.cfg.G, load, np.int64))
            d.step()
        assert_same_world(ref, port, f"tick {port.tick}")


def test_replicas_seed_the_reference_config_tick_for_tick():
    ref, port = drivers(3)
    assert port.cfg.replicas == 3 and EngineConfig(**SHAPE).replicas == 4
    assert_same_world(ref, port, "seeded")
    st = port.np_state()
    assert (st["voters_old"] == 0b0111).all() and not st["alive"][:, 3].any()
    step_both(ref, port, 150)
    assert (port.leaders_per_group() == 1).all()


def test_fewer_replicas_need_the_masked_path():
    with pytest.raises(ValueError, match="masked"):
        EngineConfig(replicas=3, use_kernels=True, **SHAPE)
    with pytest.raises(ValueError, match="replicas"):
        EngineConfig(replicas=0, **SHAPE)
    cfg = EngineConfig(replicas=3, **SHAPE)
    assert dataclasses.replace(cfg, G=8).replicas == 3


def mover_view(st, g):
    """PD's move of group ``g`` as the host sees it: the
    leader, the voter it demotes (the first after the leader), the learner,
    and whether the move may begin."""
    P = st["alive"].shape[1]
    lead_t = np.where((st["role"][g] == LEADER) & st["alive"][g], st["term"][g], -1)
    if lead_t.max() < 0:
        return None
    lead = int(np.argmax(lead_t))
    vo, vn = int(st["voters_old"][g, lead]), int(st["voters_new"][g, lead])
    follower = next(q for q in ((lead + d) % P for d in range(1, P)) if (vo >> q) & 1)
    learners = [q for q in range(P) if not ((vo | vn) >> q) & 1 and st["alive"][g, q]]
    ok = (bool(learners) and not st["joint"][g, lead]
          and st["cfg_idx"][g, lead] <= st["commit"][g, lead]
          and SHAPE["L"] - 2 - SHAPE["E"] - st["log_len"][g, lead] >= 1
          and st["match_idx"][g, lead, learners[0]] > 0)
    target = [q for q in range(P) if (vo >> q) & 1 and q != follower] + learners[:1]
    return lead, follower, target, ok


@pytest.mark.parametrize("mode", ["auto", "explicit"])
def test_batched_moves_equal_a_loop_of_the_reference_admin_ops(mode):
    """Seat a learner in every group, then begin every joint config, as
    one batched call in the port and a loop of ``add_learner`` and
    ``begin_joint`` in the reference, on the same states; a row not
    wanted is left alone, and the change runs to its exit in lockstep."""
    ref, port = drivers(11)
    step_both(ref, port, 120)
    G = SHAPE["G"]
    rows = torch.arange(G)
    want = rows % 5 != 4
    port.state, port.inbox, seat = membership.seat_learners(
        port.cfg, port.state, port.inbox, rows, want=want)
    led = [ref.leader_of(g) is not None for g in range(G)]
    for g in range(G):
        if want[g] and led[g]:
            ref.add_learner(g, 3)
    assert seat.done.tolist() == [bool(w) and led[g] for g, w in enumerate(want.tolist())]
    assert (seat.slot[seat.done] == 3).all()
    assert_same_world(ref, port, "seated")
    step_both(ref, port, 12)
    st = ref.np_state()
    views = [mover_view(st, g) for g in range(G)]
    done = []
    for g, v in enumerate(views):
        ok = bool(want[g]) and v is not None and v[3]
        if ok:
            ref.begin_joint(g, v[2])
        done.append(ok)
    assert sum(done) >= G // 2
    if mode == "auto":
        port.state, begun = membership.begin_joint(port.cfg, port.state, rows, want=want)
        assert [int(s) for s, d in zip(begun.slot, done) if d] == \
            [v[1] for v, d in zip(views, done) if d]
    else:
        masks = torch.tensor([sum(1 << q for q in v[2]) if v else 0 for v in views])
        port.state, begun = membership.begin_joint(
            port.cfg, port.state, rows, masks, want=torch.tensor(done))
    assert begun.done.tolist() == done
    assert_same_world(ref, port, "joint")
    step_both(ref, port, 40)
    st = port.np_state()
    for g in np.flatnonzero(done):
        lead = port.leader_of(int(g))
        assert not st["joint"][g, lead] and st["voters_old"][g, lead] == \
            sum(1 << q for q in views[g][2])


def moved_states(seed, G=32, rounds=4):
    """The program's state and mailbox before each of ``rounds`` event
    rounds of the j3 mix at a small size (a quarter of the groups a
    round), the rounds applied by the program's side."""
    conf = dict(manifest.cell(CELL).conf, **dict(SMALL, G=G))
    cfg = harness.engine_config(conf)
    mix = traffic.load(manifest.cell(CELL).traffic_path)
    events = manifest.module("events", mix.events).plan(
        dict(mix.event_params, share=0.25), G, seed)
    base = rprng.key(traffic.key_seed(seed))
    st = core.init_state(cfg, torch.tensor(base, dtype=torch.uint32), "cpu")
    mb = core.empty_mailbox(cfg, "cpu")
    cmds = torch.full((G,), 8, dtype=torch.int32)
    carry, t, out = None, 0, []
    for r in range(rounds):
        for _ in range(150 if r == 0 else events.every):
            st, mb, _ = core.run_ticks_traced_vec(cfg, st, mb, 1, cmds,
                                                  harness.tick_key(base, t))
            t += 1
        rows = torch.from_numpy(events.rows(r))
        out.append((st, mb, rows, carry))
        st, mb, carry = events.apply(st, mb, rows, rows, carry)
    return events, out


def test_the_program_side_and_the_reference_side_give_equal_states():
    events, rounds = moved_states(2**35 + 9)
    moved = 0
    for r, (st, mb, rows, carry) in enumerate(rounds):
        got = events.apply(st, mb, rows, rows, carry)
        ref_carry = None if carry is None else carry._replace(
            stage=carry.stage.clone(), demoted=carry.demoted.clone())
        want = events.apply_reference(st, mb, rows, rows, ref_carry)
        for a, b, kind in ((got[0], want[0], "state"), (got[1], want[1], "inbox")):
            for f in a._fields:
                assert torch.equal(getattr(a, f), getattr(b, f)), (r, kind, f)
        assert torch.equal(got[2].stage, want[2].stage), r
        moved += int((got[2].stage != (0 if carry is None else carry.stage)).sum())
    assert moved >= 3 * len(rounds[0][2])


def rows_changed(before, after):
    """bool[G]: the groups in which any plane of ``before`` differs in
    ``after`` (a state or a mailbox)."""
    out = torch.zeros(before[0].shape[0] if before[0].dim() else before[1].shape[0],
                      dtype=torch.bool)
    for a, b in zip(before, after):
        if a.dim():
            out |= (a != b).reshape(a.shape[0], -1).any(dim=1)
    return out


def test_counters_match_the_rows_the_moves_changed():
    events, rounds = moved_states(2**35 + 10, rounds=3)
    st, mb, fresh, carry = rounds[-1]
    G = st.term.shape[0]
    rows = torch.arange(G)
    stage = carry.stage
    cfg = harness.engine_config(dict(manifest.cell(CELL).conf, **dict(SMALL, G=G)))
    calls = {
        "removed": lambda: membership.remove_peers(cfg, st, mb, rows, carry.demoted,
                                                   want=stage == 3),
        "begun": lambda: membership.begin_joint(cfg, st, rows, want=stage == 2) + (mb,),
        "seated": lambda: membership.seat_learners(
            cfg, st, mb, rows, want=(stage == 1) | ((stage == 0) & torch.isin(rows, fresh))),
    }
    for kind, call in calls.items():
        membership.COUNTS.reset()
        out = call()
        new, moved = out[0], out[2] if kind != "begun" else out[1]
        new_mb = out[1] if kind != "begun" else out[2]
        got = membership.COUNTS.read()["cpu"]
        changed = rows_changed(tuple(st) + tuple(mb), tuple(new) + tuple(new_mb))
        assert torch.equal(changed, moved.done), kind
        assert got[kind] == int(changed.sum()) > 0, (kind, got)
        asked = {"removed": stage == 3, "begun": stage == 2}.get(
            kind, (stage == 1) | ((stage == 0) & torch.isin(rows, fresh)))
        assert got["deferred"] == int(asked.sum()) - got[kind], (kind, got)
        assert sum(v for k, v in got.items() if k != kind and k != "deferred"
                   and not k.startswith("deferred")) == 0


DT = 1 / 64  # fake seconds a tick at the program's pace


def paced(monkeypatch, dt=DT, step=None):
    """``step`` (the program's) on a fake clock that only the step
    advances, by ``dt`` a tick."""
    clock = {"t": 0.0}

    class FakeTime:
        @staticmethod
        def perf_counter():
            return clock["t"]

    prog = step or harness.program_step()

    def stepped(*args):
        clock["t"] += dt
        return prog(*args)

    monkeypatch.setattr(harness, "time", FakeTime)
    return stepped


def busier(monkeypatch, share=0.125):
    """The j3 mix with more groups moved a round, so that a small run
    moves many."""
    load = traffic.load

    def loaded(path):
        mix = load(path)
        if mix.events != "replica_moves":
            return mix
        return dataclasses.replace(mix, event_params=dict(mix.event_params, share=share))

    monkeypatch.setattr(traffic, "load", loaded)


def test_the_program_equals_the_joint_reference_over_a_run_with_moves(monkeypatch):
    busier(monkeypatch)
    membership.COUNTS.reset()
    out = harness.run(manifest.cell(CELL), 2**33 + 21, 200 * DT, False, "cpu",
                      step=paced(monkeypatch), conf_override=SMALL)
    assert out.window.ticks == 200
    assert out.checks == {"state_diff": {"value": 0, "limit": 0},
                          "record_diff": {"value": 0, "limit": 0}}
    got = membership.COUNTS.read()["cpu"]
    assert got["begun"] >= 6 * 8 and got["removed"] >= 5 * 8, got
    assert out.failover is None and out.writes["accepted_committed"] > 0


def test_the_control_is_not_correct(monkeypatch):
    from cellbench import control

    busier(monkeypatch)
    cell = manifest.cell(CELL)
    conf = dict(cell.conf, **SMALL)
    out = harness.run(cell, 2**33 + 22, 120 * DT, False, "cpu",
                      step=paced(monkeypatch, step=control.control_step(conf, "cpu")),
                      conf_override=SMALL)
    assert not out.correct and out.checks["record_diff"]["value"] > 0


def test_the_failure_count_does_not_depend_on_the_pace(monkeypatch):
    busier(monkeypatch)
    cell = manifest.cell(CELL)
    span = traffic.Count.load(cell.count_path)
    outs = []
    for dt in (DT, 1.5 * DT):
        outs.append(harness.run(cell, 2**40 + 5, 1.5 * (span.ticks + 4) * DT, False, "cpu",
                                step=paced(monkeypatch, dt), conf_override=dict(SMALL, G=16)))
    fast, slow = outs
    assert fast.window.ticks != slow.window.ticks
    assert fast.count == slow.count and fast.count["span"] == span.window_ticks
    assert (fast.attempted, fast.failed) == (slow.attempted, slow.failed)
    assert fast.attempted > 0 and all(o.correct for o in outs)


def lockstep(planted, monkeypatch, G=8, seed=2**34 + 3):
    """The program and the joint reference from one seed at a light load,
    every group moved: learners seated, then each joint config begun and
    at once every voter of C_old but the leader downed, in both.  C_new's
    majority (the leader and the learner) then holds entries that C_old's
    does not; the planted reference commits them."""
    conf = dict(manifest.cell(CELL).conf, G=G, L=64, E=8, INGEST=8)
    cfg = harness.engine_config(conf)
    rcfg = joint.config(conf, G)
    if planted:
        honest = joint.joint_index

        def c_new_alone(vals, state, P, *q):
            if not q:  # check-quorum
                return honest(vals, state, P)
            new = joint.quorum_index(vals, state.voters_new, P,
                                     joint.majority(state.voters_new, P))
            return torch.where(state.joint, new, honest(vals, state, P, *q))

        monkeypatch.setattr(joint, "joint_index", c_new_alone)
    events = manifest.module("events", "replica_moves").plan(
        {"share": 1.0, "every_ticks": 20, "elect_max_ticks": 20}, G, seed)
    base = rprng.key(traffic.key_seed(seed))
    rows = torch.arange(G)
    p_st = core.init_state(cfg, torch.tensor(base, dtype=torch.uint32), "cpu")
    p_mb = core.empty_mailbox(cfg, "cpu")
    r_st, r_mb = joint.init_state(rcfg, base, rows), joint.empty_mailbox(rcfg, "cpu")
    cmds = torch.full((G,), 1, dtype=torch.int32)
    recs = {"p": [], "r": []}
    p_carry = r_carry = None

    def run(n, t0):
        nonlocal p_st, p_mb, r_st, r_mb
        for t in range(t0, t0 + n):
            p_st, p_mb, rec = core.run_ticks_traced_vec(cfg, p_st, p_mb, 1, cmds,
                                                        harness.tick_key(base, t))
            recs["p"].append({k: v[0] for k, v in rec.items()})
            r_st, r_mb, rec = joint.tick(rcfg, r_st, r_mb, cmds,
                                         rprng.fold_in(rprng.fold_in(base, t), 0), rows)
            recs["r"].append(rec)
        return t0 + n

    t = run(120, 0)
    for r in range(2):
        p_st, p_mb, p_carry = events.apply(p_st, p_mb, rows, rows, p_carry)
        r_st, r_mb, r_carry = events.apply_reference(r_st, r_mb, rows, rows, r_carry)
        t = run(20 if r == 0 else 0, t)
    began = p_carry.stage == 3
    assert began.sum() >= G // 2
    lead, _ = membership.leaders(p_st, rows)
    voters = ((p_st.voters_old[rows, lead][:, None] >> torch.arange(4)) & 1) == 1
    down = voters & (torch.arange(4)[None, :] != lead[:, None]) & began[:, None]
    p_st = p_st._replace(alive=p_st.alive & ~down)
    r_st = r_st._replace(alive=r_st.alive & ~down)
    run(15, t)
    state = {f: getattr(p_st, f) for f in joint.State._fields}
    stacked = lambda side: {k: torch.stack([x[k] for x in recs[side]]) for k in recs[side][0]}
    ref_state = {f: getattr(r_st, f) for f in joint.State._fields}
    return harness.compare(state, stacked("p"), ref_state, stacked("r"))


@pytest.mark.parametrize("planted", [False, True], ids=["sound", "c_new_alone"])
def test_a_commit_under_c_new_alone_is_not_correct(planted, monkeypatch):
    checks = lockstep(planted, monkeypatch)
    diff = checks["state_diff"]["value"] + checks["record_diff"]["value"]
    assert (diff > 0) == planted, checks
