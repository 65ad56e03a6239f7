"""Raft test fixture — the ``raft/config.go`` equivalent (reference:
raft/config.go:69-142,283-340,438-619).

Builds n Raft peers in one simulated network with a fresh endpoint matrix
per incarnation, so crash/restart leaves *zombie instances* whose RPCs
can never land again (reference: raft/config.go:113-142) — the old node
object keeps firing timers harmlessly, exactly like the reference's
abandoned goroutines.

Invariant appliers cross-check every committed (index, command) pair
across all servers and enforce in-order apply
(reference: raft/config.go:144-186), and the snapshot applier
additionally snapshots every ``SNAPSHOT_INTERVAL`` applies and enforces
contiguity (reference: raft/config.go:215-274).
"""

from __future__ import annotations

import random
from typing import Any, List, Optional

from ..raft.messages import ApplyMsg
from ..raft.node import RaftNode
from ..raft.persister import Persister
from ..sim.scheduler import Scheduler
from ..transport import codec
from ..transport.network import Network, Server, Service

__all__ = ["RaftHarness", "SNAPSHOT_INTERVAL", "MAX_LOG_SIZE"]

SNAPSHOT_INTERVAL = 10  # (reference: raft/config.go:215)
MAX_LOG_SIZE = 2000  # 2D log-size gate (reference: raft/test_test.go:1110)


class HarnessError(AssertionError):
    pass


class RaftHarness:
    def __init__(
        self,
        n: int,
        unreliable: bool = False,
        snapshot: bool = False,
        seed: int = 0,
        prevote: bool = False,
    ) -> None:
        self.prevote = prevote
        self.sched = Scheduler()
        self.net = Network(self.sched, seed=seed)
        # Budget accounting: the harness and network share one Metrics
        # registry (utils/metrics.py) — RPC/byte totals accumulate
        # there, and one() records agreement latency in virtual time.
        self.metrics = self.net.metrics
        self.net.set_reliable(not unreliable)
        self.n = n
        self.seed = seed
        self.rng = random.Random(seed ^ 0xC0FFEE)
        self.use_snapshot = snapshot
        self.rafts: List[Optional[RaftNode]] = [None] * n
        self.saved: List[Persister] = [Persister() for _ in range(n)]
        self.connected = [False] * n
        self.endnames: List[List[Any]] = [[None] * n for _ in range(n)]
        self._incarnation = 0
        self.logs: List[dict] = [dict() for _ in range(n)]
        self.max_index = 0
        self.apply_err: Optional[str] = None
        self.max_command_index_seen = 0
        for i in range(n):
            self.start1(i)
        for i in range(n):
            self.connect(i)

    # -- lifecycle (reference: raft/config.go:113-142,283-340) ------------

    def crash1(self, i: int) -> None:
        """Crash server i: cut it off, suppress in-flight replies, and
        snapshot its persister so a restart sees exactly what it saved."""
        self.disconnect(i)
        self.net.delete_server(i)
        self.saved[i] = self.saved[i].copy()
        if self.rafts[i] is not None:
            self.rafts[i].kill()
            self.rafts[i] = None

    def start1(self, i: int) -> None:
        """(Re)start server i from its persisted state with a brand-new
        endpoint matrix — the previous incarnation becomes a zombie."""
        if self.rafts[i] is not None:
            self.crash1(i)
        self._incarnation += 1
        inc = self._incarnation
        ends = []
        for j in range(self.n):
            name = (i, j, inc)
            self.endnames[i][j] = name
            end = self.net.make_end(name)
            self.net.connect(name, j)
            ends.append(end)
        persister = self.saved[i].copy()
        self.saved[i] = persister
        self.logs[i] = {}

        if self.use_snapshot:
            apply_fn = self._make_applier_snap(i)
        else:
            apply_fn = self._make_applier(i)
        raft = RaftNode(
            self.sched, ends, i, persister, apply_fn,
            seed=self.seed * 131 + inc, prevote=self.prevote,
        )
        self.rafts[i] = raft
        if self.use_snapshot:
            restored = self._install_harness_snapshot(
                i, persister.read_snapshot()
            )
            self._snap_applier_state["last"] = restored
        srv = Server()
        srv.add_service(Service(raft, name="Raft"))
        self.net.add_server(i, srv)
        for j in range(self.n):
            self.net.enable(self.endnames[i][j], False)

    def connect(self, i: int) -> None:
        """(reference: raft/config.go:366-409 per-edge enable)"""
        self.connected[i] = True
        for j in range(self.n):
            if self.connected[j]:
                self.net.enable(self.endnames[i][j], True)
                self.net.enable(self.endnames[j][i], True)

    def disconnect(self, i: int) -> None:
        self.connected[i] = False
        for j in range(self.n):
            if self.endnames[i][j] is not None:
                self.net.enable(self.endnames[i][j], False)
            if self.endnames[j][i] is not None:
                self.net.enable(self.endnames[j][i], False)

    def cleanup(self) -> None:
        for r in self.rafts:
            if r is not None:
                r.kill()
        self.net.cleanup()
        if self.apply_err:
            raise HarnessError(self.apply_err)

    # -- invariant appliers (reference: raft/config.go:144-274) -----------

    def _check_logs(self, i: int, m: ApplyMsg) -> Optional[str]:
        v = m.command
        for j in range(self.n):
            old = self.logs[j].get(m.command_index)
            if old is not None and old != v:
                return (
                    f"commit index={m.command_index} server={i} {v} != "
                    f"server={j} {old}"
                )
        prev_ok = (m.command_index - 1) in self.logs[i] or m.command_index <= 1
        self.logs[i][m.command_index] = v
        if m.command_index > self.max_index:
            self.max_index = m.command_index
        if not prev_ok:
            return f"server {i} apply out of order {m.command_index}"
        return None

    def _make_applier(self, i: int):
        def apply_fn(m: ApplyMsg) -> None:
            if not m.command_valid:
                return
            err = self._check_logs(i, m)
            if err and self.apply_err is None:
                self.apply_err = err

        return apply_fn

    def _install_harness_snapshot(self, i: int, data: bytes) -> int:
        if not data:
            return 0
        blob = codec.decode(data)
        self.logs[i] = {idx + 1: v for idx, v in enumerate(blob["xlog"])}
        return blob["last_index"]

    def _make_applier_snap(self, i: int):
        """Applier that snapshots every SNAPSHOT_INTERVAL applies and
        enforces contiguous apply (reference: raft/config.go:215-274)."""
        state = {"last": 0}
        self._snap_applier_state = state  # resynced by start1 on restart

        def apply_fn(m: ApplyMsg) -> None:
            if m.snapshot_valid:
                state["last"] = self._install_harness_snapshot(i, m.snapshot)
                return
            if not m.command_valid:
                return
            if m.command_index != state["last"] + 1 and self.apply_err is None:
                self.apply_err = (
                    f"server {i} apply out of order, expected index "
                    f"{state['last'] + 1}, got {m.command_index}"
                )
                return
            err = self._check_logs(i, m)
            if err and self.apply_err is None:
                self.apply_err = err
                return
            state["last"] = m.command_index
            if m.command_index % SNAPSHOT_INTERVAL == 0:
                xlog = [
                    self.logs[i][k] for k in range(1, m.command_index + 1)
                ]
                blob = codec.encode(
                    {"last_index": m.command_index, "xlog": xlog}
                )
                raft = self.rafts[i]
                if raft is not None:
                    raft.snapshot(m.command_index, blob)

        return apply_fn

    # -- checks (reference: raft/config.go:438-619) -----------------------

    def check_one_leader(self) -> int:
        for _ in range(10):
            self.sched.run_for(self.rng.uniform(0.45, 0.55))
            leaders: dict[int, list[int]] = {}
            for i in range(self.n):
                if self.connected[i] and self.rafts[i] is not None:
                    term, is_leader = self.rafts[i].get_state()
                    if is_leader:
                        leaders.setdefault(term, []).append(i)
            last_term_with_leader = -1
            for term, who in leaders.items():
                if len(who) > 1:
                    raise HarnessError(
                        f"term {term} has {len(who)} (>1) leaders"
                    )
                last_term_with_leader = max(last_term_with_leader, term)
            if leaders:
                return leaders[last_term_with_leader][0]
        raise HarnessError("expected one leader, got none")

    def check_terms(self) -> int:
        term = -1
        for i in range(self.n):
            if self.connected[i] and self.rafts[i] is not None:
                t, _ = self.rafts[i].get_state()
                if term == -1:
                    term = t
                elif term != t:
                    raise HarnessError("servers disagree on term")
        return term

    def check_no_leader(self) -> None:
        for i in range(self.n):
            if self.connected[i] and self.rafts[i] is not None:
                _, is_leader = self.rafts[i].get_state()
                if is_leader:
                    raise HarnessError(
                        f"expected no leader, but {i} claims to be leader"
                    )

    def n_committed(self, index: int) -> tuple[int, Any]:
        count, cmd = 0, None
        for i in range(self.n):
            if self.apply_err:
                raise HarnessError(self.apply_err)
            v = self.logs[i].get(index)
            if v is not None:
                if count > 0 and cmd != v:
                    raise HarnessError(
                        f"committed values do not match: index {index}, "
                        f"{cmd}, {v}"
                    )
                count += 1
                cmd = v
        return count, cmd

    def wait(self, index: int, n: int, start_term: int) -> Any:
        """(reference: raft/config.go:528-555)"""
        to = 0.01
        for _ in range(30):
            nd, _ = self.n_committed(index)
            if nd >= n:
                break
            self.sched.run_for(to)
            if to < 1.0:
                to *= 2
            if start_term > -1:
                for r in self.rafts:
                    if r is not None:
                        t, _ = r.get_state()
                        if t > start_term:
                            return -1  # term moved on; can't guarantee
        nd, cmd = self.n_committed(index)
        if nd < n:
            raise HarnessError(
                f"only {nd} decided for index {index}; wanted {n}"
            )
        return cmd

    def one(self, cmd: Any, expected_servers: int, retry: bool) -> int:
        """Submit until agreed (reference: raft/config.go:569-619)."""
        t0 = self.sched.now
        starts = 0
        while self.sched.now - t0 < 10.0:
            index = -1
            for _ in range(self.n):
                starts = (starts + 1) % self.n
                rf = self.rafts[starts]
                if self.connected[starts] and rf is not None:
                    ix, _, ok = rf.start(cmd)
                    if ok:
                        index = ix
                        break
            if index != -1:
                t1 = self.sched.now
                while self.sched.now - t1 < 2.0:
                    nd, cmd1 = self.n_committed(index)
                    if nd >= expected_servers and cmd1 == cmd:
                        self.metrics.inc("one_agreements")
                        self.metrics.observe("one_latency_s", self.sched.now - t0)
                        return index
                    self.sched.run_for(0.02)
                if not retry:
                    raise HarnessError(f"one({cmd!r}) failed to reach agreement")
            else:
                self.sched.run_for(0.05)
        raise HarnessError(f"one({cmd!r}) failed to reach agreement (timeout)")

    # -- stats ------------------------------------------------------------

    def rpc_count(self, server: int) -> int:
        return self.net.get_count(server)

    def rpc_total(self) -> int:
        return self.net.get_total_count()

    def bytes_total(self) -> int:
        return self.net.get_total_bytes()

    def log_size(self) -> int:
        return max(p.raft_state_size() for p in self.saved)
