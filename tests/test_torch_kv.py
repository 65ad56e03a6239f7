"""The port's BatchedKV (multiraft_tpu_torch/engine/kv.py, frontier.py)
against the reference BatchedKV, call for call.

Both services get the same ``submit`` (Put/Append/Get through the log,
with client sessions) and ``get`` (read-index fast reads) calls over
several groups, and a group loses its leader mid-run; failed tickets are
resubmitted under the same (client_id, command_id), so session dedup
keeps them exactly-once.  Ticket outcomes, applied data, sessions and
the recorded porcupine histories must be equal, and the port's history
must pass the reference's porcupine checker.
"""

import numpy as np
import torch

from multiraft_tpu.engine.core import EngineConfig as JaxConfig
from multiraft_tpu.engine.host import EngineDriver as JaxDriver
from multiraft_tpu.engine.kv import BatchedKV as JaxKV
from multiraft_tpu.engine.kv import KVOp as JaxOp
from multiraft_tpu.porcupine.kv import KvInput, KvOutput, kv_model
from multiraft_tpu.porcupine.model import Operation
from multiraft_tpu.porcupine.visualization import assert_linearizable
from multiraft_tpu_torch.engine.core import EngineConfig
from multiraft_tpu_torch.engine.host import EngineDriver
from multiraft_tpu_torch.engine.kv import BatchedKV, KVOp
from multiraft_tpu_torch.porcupine import types as ptypes

# Small shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the host's cores.
torch.set_num_threads(1)

SHAPE = dict(G=6, P=3, L=32, E=4, INGEST=4)
RECORD = [2, 3]


def _ticket(t):
    return (t.group, t.done, t.failed, t.value, t.index, t.submit_tick, t.done_tick)


def _history(kv, g):
    return [
        (o.client_id, o.input.op, o.input.key, o.input.value, o.call,
         o.output.value, o.ret)
        for o in kv.histories[g]
    ]


def test_batched_kv_matches_reference_through_a_leader_kill():
    ref_d = JaxDriver(JaxConfig(**SHAPE), seed=4)
    ref_d._pipeline_on = False
    port_d = EngineDriver(EngineConfig(**SHAPE), seed=4, device="cpu")
    assert ref_d.run_until_quiet_leaders(300)
    assert port_d.run_until_quiet_leaders(300)
    ref, port = JaxKV(ref_d, record_groups=RECORD), BatchedKV(port_d, record_groups=RECORD)
    rng = np.random.default_rng(9)
    tickets = []  # (ref ticket, port ticket, group, args)
    cmd = {}
    for rnd in range(30):
        if rnd == 8:
            lead = ref_d.leader_of(3)
            assert lead == port_d.leader_of(3)
            ref_d.set_alive(3, lead, False)
            port_d.set_alive(3, lead, False)
        for _ in range(int(rng.integers(2, 6))):
            g = int(rng.integers(0, SHAPE["G"]))
            client = int(rng.integers(1, 4))
            op = int(rng.choice([0, 1, 2, 2]))  # Get / Put / Append
            key = f"k{int(rng.integers(0, 3))}"
            cmd[client] = cmd.get(client, 0) + 1
            args = (op, key, f"{rnd}.{client};", client, cmd[client])
            tickets.append((
                ref.submit(g, JaxOp(*args)), port.submit(g, KVOp(*args)), g, args,
            ))
        for _ in range(int(rng.integers(0, 3))):
            g, key = int(rng.integers(0, SHAPE["G"])), f"k{int(rng.integers(0, 3))}"
            a, b = ref.get(g, key), port.get(g, key)
            assert _ticket(a) == _ticket(b)
        n = int(rng.integers(1, 4))
        ref.pump(n)
        port.pump(n)
        for i, (a, b, g, args) in enumerate(tickets):
            assert _ticket(a) == _ticket(b), (rnd, i)
            if a.failed:
                # Lost to the leader change: resubmit under the same
                # session ids (dedup keeps it exactly-once).
                tickets[i] = (ref.submit(g, JaxOp(*args)),
                              port.submit(g, KVOp(*args)), g, args)
        assert ref.data == port.data and ref.sessions == port.sessions
    for _ in range(60):
        if all(a.done and b.done for a, b, _, _ in tickets):
            break
        ref.pump(2)
        port.pump(2)
    assert all(b.done and not b.failed for _, b, _, _ in tickets)
    assert [_ticket(a) for a, *_ in tickets] == [_ticket(b) for _, b, *_ in tickets]
    assert ref.data == port.data and ref.sessions == port.sessions
    assert ref.applied_upto == port.applied_upto
    assert any(port.data), "nothing was applied"
    for g in RECORD:
        assert _history(ref, g) == _history(port, g)
        assert port.histories[g] and all(
            isinstance(o, ptypes.Operation) for o in port.histories[g]
        )
        history = [
            Operation(
                client_id=o.client_id,
                input=KvInput(op=o.input.op, key=o.input.key, value=o.input.value),
                call=o.call,
                output=KvOutput(value=o.output.value),
                ret=o.ret,
            )
            for o in port.histories[g]
        ]
        assert_linearizable(kv_model, history, timeout=5.0, name=f"port-group-{g}")


def test_sweep_orphans_fails_bindings_past_the_log_end():
    """A binding beyond the leader's log end is failed by the orphan
    sweep (the frontier's periodic cleanup) — its ticket resolves."""
    d = EngineDriver(EngineConfig(**SHAPE), seed=2, device="cpu")
    assert d.run_until_quiet_leaders(300)
    kv = BatchedKV(d)
    t = kv.submit(0, KVOp(1, "a", "x"))
    kv.pump(4)
    assert t.done and not t.failed and kv.data[0]["a"] == "x"
    lost = KVOp(1, "b", "y")
    from multiraft_tpu_torch.engine.kv import Ticket

    orphan = Ticket(group=0)
    d.payloads[(0, 10_000)] = (lost, orphan)
    assert kv.sweep_orphans() == 1
    assert orphan.done and orphan.failed
