"""One tick of the port (multiraft_tpu_torch/engine/core.py) against one
tick of the reference ``core.tick_impl``, on the same state, inbox,
``new_cmds`` and key.

The states come from a reference engine driven under message drops, a
partition and a crashed replica, and cross through
``multiraft_tpu_torch.convert`` as numpy.  Every ``EngineState`` plane,
every ``Mailbox`` plane and every metric must be equal, dtype included:
all of them are int32 or bool, so the tolerance is zero.  The flag
matrix is pruned but takes every flag both ways; with ``membership`` on
(and the kernel path off) the voter masks are seeded so the masked
joint-consensus reductions really run.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiraft_tpu.engine import core as jcore
from multiraft_tpu.engine.host import EngineDriver as JaxDriver
from multiraft_tpu_torch import convert
from multiraft_tpu_torch.engine import core as tcore

# Small shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the host's cores.
torch.set_num_threads(1)

SHAPE = dict(G=12, L=32, E=4, INGEST=4)


def assert_planes_equal(want: dict, got: dict, what: str) -> None:
    assert set(want) == set(got), what
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.dtype == b.dtype, f"{what}.{k}: {a.dtype} != {b.dtype}"
        assert a.shape == b.shape, f"{what}.{k}: {a.shape} != {b.shape}"
        if not np.array_equal(a, b):
            at = np.argwhere(a != b)[:4]
            raise AssertionError(
                f"{what}.{k} differs at {at.tolist()}: "
                f"reference {a[tuple(at.T)]} port {b[tuple(at.T)]}"
            )


@functools.lru_cache(maxsize=None)
def driven_snapshots(P: int):
    """(state, inbox) numpy snapshots of reference engines.

    Three from an engine driven under a firehose, 15% drops, a one-way
    edge cut, a partitioned replica and a crashed one (elections,
    catch-up and ring snapshots in flight), and one from a quiet engine
    just after every group changed leader: short logs of an older term
    and every append lane uniform, the case the reference's
    uniform-suffix fast path decides."""
    cfg = jcore.EngineConfig(P=P, **SHAPE)
    d = JaxDriver(cfg, seed=11)
    d._pipeline_on = False
    rng = np.random.default_rng(P)
    snaps = []

    def snap(drv):
        snaps.append((
            {k: np.asarray(v) for k, v in drv.state._asdict().items()},
            {k: np.asarray(v) for k, v in drv.inbox._asdict().items()},
        ))

    for i in range(100):
        if i == 15:
            d.drop_prob = 0.15
        if i == 30:
            d.set_edge(2, 0, 1, False)
            d.partition_replica(0, 1, False)
        if i == 45:
            d.set_alive(1, 0, False)
        if i == 70:
            d.partition_replica(0, 1, True)
        if i % 4 == 0:
            for g in range(SHAPE["G"]):
                for _ in range(int(rng.integers(0, 4))):
                    d.start(g, None)
        d.step(1)
        if i in (25, 55, 99):
            snap(d)
    q = JaxDriver(cfg, seed=12)
    q._pipeline_on = False
    assert q.run_until_quiet_leaders(300)
    for g in range(SHAPE["G"]):
        q.start(g, None)
    q.step(6)
    for g in range(SHAPE["G"]):
        q.set_alive(g, q.leader_of(g), False)
    assert q.run_until_quiet_leaders(300)
    for g in range(SHAPE["G"]):
        q.start(g, None)
    q.step(2)
    snap(q)
    return tuple(snaps)


def seed_voter_masks(st: dict, mb: dict, P: int, seed: int):
    """Config views with real voter masks and joint phases, so the
    masked reductions decide (the init state's full masks would make
    them equal to the single-quorum math)."""
    rng = np.random.default_rng(seed)
    st, mb = dict(st), dict(mb)
    G = st["term"].shape[0]
    full = (1 << P) - 1

    def masks(shape):
        m = rng.integers(1, full + 1, shape).astype(np.int32)
        return np.where(rng.random(shape) < 0.3, np.int32(full), m)

    old = masks((G, 1)).repeat(P, axis=1)
    new = np.where(rng.random((G, P)) < 0.5, old, masks((G, P)))
    st["voters_old"], st["voters_new"] = old, new
    st["joint"] = old != new
    st["cfg_idx"] = (st["commit"] + rng.integers(-2, 3, (G, P))).astype(np.int32)
    st["cfg_epoch"] = rng.integers(0, 3, (G, P)).astype(np.int32)
    for f in ("ar_cfg_old", "ar_cfg_new"):
        mb[f] = masks((G, P, P))
    mb["ar_cfg_joint"] = mb["ar_cfg_old"] != mb["ar_cfg_new"]
    mb["ar_cfg_idx"] = (
        mb["ar_commit"] + rng.integers(-2, 6, (G, P, P))
    ).astype(np.int32)
    mb["ar_cfg_epoch"] = rng.integers(0, 4, (G, P, P)).astype(np.int32)
    return st, mb


@functools.lru_cache(maxsize=None)
def jax_tick(cfg):
    return jax.jit(functools.partial(jcore.tick_impl, cfg))


# (P, prevote, check_quorum, membership, kernels, host_paced_compaction)
MATRIX = [
    (3, True, True, True, False, False),
    (3, False, False, False, False, False),
    (3, True, True, False, True, False),
    (3, False, True, True, True, False),
    (3, True, False, True, False, True),
    (5, True, True, True, False, False),
    (5, False, False, False, True, False),
    (5, True, False, False, False, False),
    (5, False, True, True, False, False),
]


@pytest.mark.parametrize(
    "P,prevote,check_quorum,membership,kernels,paced", MATRIX,
    ids=[
        f"P{m[0]}-pv{int(m[1])}-cq{int(m[2])}-mem{int(m[3])}"
        f"-k{int(m[4])}-hp{int(m[5])}" for m in MATRIX
    ],
)
def test_one_tick_matches_reference(
    P, prevote, check_quorum, membership, kernels, paced
):
    jcfg = jcore.EngineConfig(
        P=P, prevote=prevote, check_quorum=check_quorum,
        membership=membership, use_pallas=kernels, pallas_interpret=kernels,
        host_paced_compaction=paced, **SHAPE,
    )
    tcfg = convert.config_from_fields(dataclasses.asdict(jcfg))
    assert tcfg.use_kernels == kernels
    assert tcfg.membership_on == jcfg.membership_on
    rng = np.random.default_rng(P * 100 + len(str(tcfg)))
    for n, (st, mb) in enumerate(driven_snapshots(P)):
        if jcfg.membership_on:
            st, mb = seed_voter_masks(st, mb, P, seed=n)
        new_cmds = rng.integers(0, 7, SHAPE["G"]).astype(np.int32)
        key = jax.random.fold_in(jax.random.PRNGKey(n + 3), int(st["tick_no"]))
        want_st, want_mb, want_m = jax_tick(jcfg)(
            jcore.EngineState(**{k: jnp.asarray(v) for k, v in st.items()}),
            jcore.Mailbox(**{k: jnp.asarray(v) for k, v in mb.items()}),
            jnp.asarray(new_cmds), key,
        )
        got_st, got_mb, got_m = tcore.tick_impl(
            tcfg,
            convert.state_from_numpy(st, "cpu"),
            convert.mailbox_from_numpy(mb, "cpu"),
            torch.from_numpy(new_cmds),
            convert.key_from_numpy(np.asarray(key)),
        )
        assert_planes_equal(want_st._asdict(), convert.state_to_numpy(got_st), "state")
        assert_planes_equal(want_mb._asdict(), convert.mailbox_to_numpy(got_mb), "mailbox")
        assert_planes_equal(
            want_m, {k: v.numpy() for k, v in got_m.items()}, "metrics"
        )
        assert set(got_m) == set(tcore.METRIC_KEYS)


def test_snapshots_cover_the_interesting_planes():
    """The driven states are not idle: leaders, candidates, dead
    replicas, compacted rings and in-flight appends are all present."""
    for P in (3, 5):
        planes = [st for st, _ in driven_snapshots(P)]
        assert any((s["role"] == 2).any() for s in planes)
        assert any((s["role"] == 1).any() for s in planes)
        assert any((~s["alive"]).any() for s in planes)
        assert any((s["base"] > 0).any() for s in planes)
        assert any(mb["ar_active"].any() for _, mb in driven_snapshots(P))


def test_run_ticks_traced_matches_reference():
    jcfg = jcore.EngineConfig(P=3, use_pallas=True, pallas_interpret=True, **SHAPE)
    tcfg = convert.config_from_fields(dataclasses.asdict(jcfg))
    st, mb = driven_snapshots(3)[1]
    key = jax.random.PRNGKey(21)
    want_st, want_mb, want_rec = jcore.run_ticks_traced(
        jcfg,
        jcore.EngineState(**{k: jnp.array(v) for k, v in st.items()}),
        jcore.Mailbox(**{k: jnp.array(v) for k, v in mb.items()}),
        12, 3, key,
    )
    tkey = convert.key_from_numpy(np.asarray(key))
    got_st, got_mb, got_rec = tcore.run_ticks_traced(
        tcfg, convert.state_from_numpy(st, "cpu"),
        convert.mailbox_from_numpy(mb, "cpu"), 12, 3, tkey,
    )
    assert_planes_equal(want_st._asdict(), convert.state_to_numpy(got_st), "state")
    assert_planes_equal(want_mb._asdict(), convert.mailbox_to_numpy(got_mb), "mailbox")
    assert_planes_equal(want_rec, {k: v.numpy() for k, v in got_rec.items()}, "rec")
    # run_ticks is the same loop without the record.
    plain_st, plain_mb = tcore.run_ticks(
        tcfg, convert.state_from_numpy(st, "cpu"),
        convert.mailbox_from_numpy(mb, "cpu"), 12, 3, tkey,
    )
    assert_planes_equal(
        convert.state_to_numpy(got_st), convert.state_to_numpy(plain_st), "state"
    )


def test_state_and_mailbox_round_trip_through_convert():
    st, mb = driven_snapshots(3)[0]
    t_st = convert.state_from_numpy(st, "cpu")
    assert t_st.term.dtype == torch.int32 and t_st.alive.dtype == torch.bool
    assert_planes_equal(st, convert.state_to_numpy(t_st), "state")
    assert_planes_equal(
        mb, convert.mailbox_to_numpy(convert.mailbox_from_numpy(mb, "cpu")),
        "mailbox",
    )
    key = np.asarray(jax.random.PRNGKey(4))
    np.testing.assert_array_equal(convert.key_from_numpy(key).numpy(), key)
    cfg = convert.config_from_fields(
        dataclasses.asdict(jcore.EngineConfig(use_pallas=True))
    )
    assert cfg.use_kernels and not cfg.membership_on
    with pytest.raises(TypeError):
        convert.state_from_numpy({**st, "term": st["term"].astype(np.int64)}, "cpu")
