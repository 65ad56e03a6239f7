"""The port's simulated labrpc ``Network`` against the JAX package's, on
the CPU.

One seeded RPC script (many clients, plain and coroutine handlers,
Raft messages on the wire, a partition, a crash with a replacement
server) runs through both packages' ``Network`` under the reliable,
unreliable and long-reordering fault modes.  Every call's outcome and
resolve time, the per-server delivery counts, ``get_total_count`` and
``get_total_bytes`` must be equal.
"""

import pytest

import multiraft_tpu.raft.messages as ref_msgs
import multiraft_tpu.sim.scheduler as ref_sched
import multiraft_tpu.transport.network as ref_net
import multiraft_tpu_torch.raft.messages as port_msgs
import multiraft_tpu_torch.sim.scheduler as port_sched
import multiraft_tpu_torch.transport.network as port_net

PACKAGES = {
    "ref": (ref_sched, ref_net, ref_msgs),
    "port": (port_sched, port_net, port_msgs),
}


class Handlers:
    """A service whose replies depend on what it was sent and when."""

    def __init__(self, sched, msgs, tag):
        self.sched, self.msgs, self.tag = sched, msgs, tag
        self.seen = []

    def echo(self, args):
        self.seen.append(args)
        return (self.tag, args, len(self.seen))

    def slow(self, args):
        yield 0.015 * (1 + args % 3)
        self.seen.append(args)
        return -args

    def vote(self, args):
        # Mutating what arrived must not reach the caller's object.
        args.term += 100
        self.seen.append(args.term)
        return self.msgs.RequestVoteReply(
            term=args.term, vote_granted=args.candidate_id % 2 == 0
        )

    def append(self, args):
        self.seen.append(len(args.entries))
        return self.msgs.AppendEntriesReply(
            term=args.term, success=True,
            conflict_index=args.prev_log_index + len(args.entries),
        )


def run_script(pkg: str, mode: str, seed: int) -> dict:
    sched_mod, net_mod, msgs = PACKAGES[pkg]
    sched = sched_mod.Scheduler()
    net = net_mod.Network(sched, seed=seed)
    if mode == "unreliable":
        net.set_reliable(False)
    elif mode == "reordering":
        net.set_reliable(False)
        net.set_long_reordering(True)
    elif mode == "long_delays":
        net.set_long_delays(True)

    services = {}

    def add(name, tag):
        h = Handlers(sched, msgs, tag)
        srv = net_mod.Server()
        srv.add_service(net_mod.Service(h, name="H"))
        net.add_server(name, srv)
        services[name] = h

    for s in range(3):
        add(s, f"s{s}-a")
    ends = {}
    for c in range(4):
        for s in range(3):
            name = (c, s)
            ends[name] = net.make_end(name)
            net.connect(name, s)
            net.enable(name, True)

    outcomes = []
    sent_votes = []

    def client(c):
        for k in range(24):
            s = (c + k) % 3
            end = ends[(c, s)]
            kind = k % 4
            if kind == 0:
                fut = end.call("H.echo", f"c{c}k{k}")
            elif kind == 1:
                fut = end.call("H.slow", c * 100 + k)
            elif kind == 2:
                args = msgs.RequestVoteArgs(
                    term=k, candidate_id=c, last_log_index=k, last_log_term=1
                )
                sent_votes.append(args)
                fut = end.call("H.vote", args)
            else:
                fut = end.call("H.append", msgs.AppendEntriesArgs(
                    term=k, leader_id=c, prev_log_index=k, prev_log_term=1,
                    entries=[msgs.Entry(index=k + j, term=1, command=f"x{j}")
                             for j in range(k % 5)],
                    leader_commit=k,
                ))
            reply = yield fut
            if isinstance(reply, (msgs.RequestVoteReply, msgs.AppendEntriesReply)):
                reply = (type(reply).__name__, *vars(reply).values())
            outcomes.append((c, k, reply, round(sched.now, 12)))
            yield 0.003 * (1 + (c + k) % 5)

    procs = [sched.spawn(client(c)) for c in range(4)]
    sched.run_for(0.05)
    # A partition of client 1's edge to server 2, healed later.
    net.enable((1, 2), False)
    sched.run_for(0.1)
    # Server 0 crashes; a fresh instance replaces it.
    net.delete_server(0)
    sched.run_for(0.05)
    add(0, "s0-b")
    net.enable((1, 2), True)
    sched.run_for(30.0)
    assert all(p.done for p in procs)
    return {
        "outcomes": outcomes,
        "seen": {k: list(v.seen) for k, v in services.items()},
        "votes_unchanged": [a.term for a in sent_votes],
        "count": [net.get_count(s) for s in range(3)],
        "total": net.get_total_count(),
        "bytes": net.get_total_bytes(),
        "now": sched.now,
    }


@pytest.mark.parametrize("mode", ["reliable", "unreliable", "reordering", "long_delays"])
@pytest.mark.parametrize("seed", [0, 7])
def test_rpc_script_matches_reference(mode, seed):
    ref = run_script("ref", mode, seed)
    port = run_script("port", mode, seed)
    assert port == ref
    # The script really reached every outcome the mode allows.
    replies = [o[2] for o in port["outcomes"]]
    assert len(replies) == 96
    if mode == "reliable":
        assert sum(r is None for r in replies) > 0  # the crash and the cut
        assert port["bytes"] > 0
    if mode in ("unreliable", "reordering"):
        assert sum(r is None for r in replies) > sum(
            o[2] is None for o in run_script("port", "reliable", seed)["outcomes"]
        )


def test_arguments_are_copied_across_the_wire():
    out = run_script("port", "reliable", 0)
    # The handler added 100 to each term it received; the senders'
    # objects kept theirs.
    assert all(t < 100 for t in out["votes_unchanged"])
    assert any(t >= 100 for s in out["seen"].values() for t in s
               if isinstance(t, int))


def test_unregistered_class_is_refused():
    sched = port_sched.Scheduler()
    net = port_net.Network(sched, seed=0)

    class Stray:
        pass

    end = net.make_end("e")
    from multiraft_tpu_torch.transport import codec

    with pytest.raises(codec.CodecError):
        end.call("H.echo", Stray())


def test_same_fault_model_as_reference():
    from multiraft_tpu.utils.config import settings as ref_settings
    from multiraft_tpu_torch.utils.config import settings

    assert vars(settings().faults) == vars(ref_settings().faults)
    assert port_net.RELIABLE_HOP_DELAY == ref_net.RELIABLE_HOP_DELAY
