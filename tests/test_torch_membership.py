"""The port's joint-consensus admin ops (``seed_config``, ``add_learner``,
``learner_match``, ``begin_joint``, ``config_of``, ``reconfiguring``) in
lockstep with the reference on the plain (masked) path, and every
refusal raising the reference's exception type.

The flows are those of ``tests/test_membership.py``: a learner catches up
without voting, a joint change needs both quorums and exits to the new
config, and a leader outside the new config steps down once the exit
entry commits.  At every step the worlds, ``config_of``,
``learner_match`` and ``reconfiguring`` must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiraft_tpu_torch.engine.core import FOLLOWER, LEADER
from tests.test_torch_chaos import assert_same_world, pair

# Small shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the host's cores.
torch.set_num_threads(1)


def step_both(ref, port, n=1):
    for _ in range(n):
        ref.step()
        port.step()
        assert np.array_equal(ref.reconfiguring(), port.reconfiguring())


def elect(ref, port):
    assert ref.run_until_quiet_leaders(400) and port.run_until_quiet_leaders(400)
    assert_same_world(ref, port, "elected")
    lead = port.leader_of(0)
    assert lead == ref.leader_of(0)
    return lead


def settle(ref, port, g, target, max_ticks=600) -> bool:
    for _ in range(max_ticks):
        step_both(ref, port)
        lead = port.leader_of(g)
        assert lead == ref.leader_of(g)
        if lead is None:
            continue
        c = port.config_of(g)
        assert c == ref.config_of(g)
        if not c["joint"] and c["voters_old"] == c["voters_new"] == target:
            return True
    return False


def test_learner_catches_up_without_voting():
    ref, port = pair(1, 4, 1, kernels=False)
    for d in (ref, port):
        d.seed_config([0, 1, 2])
    assert_same_world(ref, port, "seeded")
    elect(ref, port)
    for d in (ref, port):
        for i in range(10):
            d.start(0, f"x{i}")
    step_both(ref, port, 120)
    for d in (ref, port):
        d.add_learner(0, 3)
    assert_same_world(ref, port, "learner")
    caught = False
    for _ in range(150):
        step_both(ref, port)
        m = port.learner_match(0, 3)
        assert m == ref.learner_match(0, 3)
        if m[0] >= m[1]:
            caught = True
            break
    assert caught
    assert_same_world(ref, port, "caught up")
    st = port.np_state()
    assert st["role"][0, 3] == FOLLOWER
    assert not ((int(st["voters_old"][0, 3]) | int(st["voters_new"][0, 3])) >> 3) & 1
    c = port.config_of(0)
    assert c == ref.config_of(0)
    assert c["voters_old"] == [0, 1, 2] and not c["joint"]
    for p in range(4):
        assert port.config_of(0, p) == ref.config_of(0, p)


def test_joint_change_needs_both_quorums_then_exits():
    ref, port = pair(1, 5, 3, kernels=False)
    lead = elect(ref, port)
    others = [q for q in range(5) if q != lead]
    a, b = others[0], others[1]
    for d in (ref, port):
        for i in range(3):
            d.start(0, f"pre-{i}")
    step_both(ref, port, 60)
    for d in (ref, port):
        for p in (a, b):
            for q in range(5):
                if q != p:
                    d.set_edge(0, p, q, False)
                    d.set_edge(0, q, p, False)
    assert ref.begin_joint(0, [lead, a, b]) == port.begin_joint(0, [lead, a, b])
    assert port.reconfiguring()[0]
    step_both(ref, port, 2 * port.cfg.ELECT_MAX)
    assert_same_world(ref, port, "joint, severed")
    for d in (ref, port):
        for s in range(5):
            for t in range(5):
                d.set_edge(0, s, t, True)
    assert settle(ref, port, 0, sorted([lead, a, b]))
    assert_same_world(ref, port, "exited")
    for _ in range(60):  # until the exit entry commits
        if not port.reconfiguring()[0]:
            break
        step_both(ref, port)
    assert not port.reconfiguring()[0]
    port.check_log_matching(0)


def test_removed_leader_steps_down_after_exit_commit():
    ref, port = pair(1, 4, 9, kernels=False)
    lead = elect(ref, port)
    target = [q for q in range(4) if q != lead]
    assert ref.begin_joint(0, target) == port.begin_joint(0, target)
    assert settle(ref, port, 0, target)
    for _ in range(3 * port.cfg.ELECT_MAX):
        step_both(ref, port)
        new = port.leader_of(0)
        if new is not None and new != lead:
            break
    assert_same_world(ref, port, "handed over")
    assert port.np_state()["role"][0, lead] != LEADER
    assert port.leader_of(0) in target


def _refusals(d, lead):
    """Each refused call on driver ``d`` -> the exception type raised."""
    P = d.cfg.P
    voter = (lead + 1) % P
    calls = {
        "add_learner leader": lambda: d.add_learner(0, lead),
        "add_learner voter": lambda: d.add_learner(0, voter),
        "begin_joint empty": lambda: d.begin_joint(0, []),
        "begin_joint out of range": lambda: d.begin_joint(0, [0, P]),
        "begin_joint same config": lambda: d.begin_joint(0, range(P)),
        "seed_config after a tick": lambda: d.seed_config([0, 1]),
        "seed_config bad set": lambda: d.seed_config([P]),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except (ValueError, RuntimeError) as e:
            out[name] = type(e).__name__
    return out


def test_refusals_raise_the_reference_types():
    ref, port = pair(2, 4, 11, kernels=False)
    lead = elect(ref, port)
    got, want = _refusals(port, lead), _refusals(ref, lead)
    assert got == want
    assert None not in got.values(), got
    # One change at a time.
    target = [q for q in range(4) if q != (lead + 1) % 4]
    for d in (ref, port):
        d.begin_joint(0, target)
    for d in (ref, port):
        with pytest.raises(RuntimeError, match="one at a time"):
            d.begin_joint(0, [0, 1])
    # No headroom in group 1's leader log (planted by state surgery).
    lead1 = port.leader_of(1)
    ll = port.np_state()["log_len"].copy()
    ll[1, lead1] = port.cfg.L - 2 - port.cfg.E
    ref.state = ref.state._replace(log_len=jnp.asarray(ll))
    port.state = port.state._replace(log_len=torch.from_numpy(ll))
    for d in (ref, port):
        with pytest.raises(RuntimeError, match="headroom"):
            d.begin_joint(1, [0, 1, 2])
    # No leader: a whole group down.
    for d in (ref, port):
        for p in range(4):
            d.set_alive(1, p, False)
        for call in (lambda: d.add_learner(1, 0), lambda: d.learner_match(1, 0),
                     lambda: d.begin_joint(1, [0]), lambda: d.config_of(1)):
            with pytest.raises(RuntimeError, match="no leader"):
                call()


def test_kernel_path_refuses_admin_ops():
    """The kernels are mask-unaware: membership_on is off on the kernel
    path, and every admin op refuses there, as in the reference."""
    ref, port = pair(1, 3, 0, kernels=True)
    assert port.cfg.membership and not port.cfg.membership_on
    for d in (ref, port):
        for call in (lambda: d.add_learner(0, 1), lambda: d.begin_joint(0, [0, 1]),
                     lambda: d.seed_config([0, 1])):
            with pytest.raises(RuntimeError, match="mask-unaware"):
                call()
