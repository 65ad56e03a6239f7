"""One run of one cell: set-up, the measured window, the drain, the
reference's check and the metrics.

The program under test is ``multiraft_tpu_torch``: the window calls
``engine.core.run_ticks_traced_vec`` one tick at a time, with the
configuration's kernels on, and records a CUDA event after each tick
without synchronising, so the host stays ahead of the device and every
tick has a device timestamp.  Leader kills (:mod:`.surgery`) are
enqueued between ticks.  After the window the drain runs a few more
ticks without new kills, so that the window's last victims can be
served again; nothing of the drain counts towards ``writes_per_s``.

A traced run traces two stretches of the window back to back: the first
with the device's activity alone, from which the device's busy and idle
time, the launches and the kernels' times are read; the second with the
host's activity too, which slows the host, for the breakdown of the
device's idle time by what the host was doing.

Once the drain has ended and the peak memory is read, the program's
state is freed and :mod:`.reference` replays a sample of groups, drawn
from the seed, from the same inputs: its final state and its per-tick
records have to equal the program's, value for value.

:func:`run` takes the device and may take another ``step`` in place of
the program's; the command line (:mod:`.run`) passes the card only.
"""

from __future__ import annotations

import contextlib
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import latency, surgery, traffic
from .manifest import Cell
from .reference import prng as rprng
from .reference import tick as rtick
from .trace import STRETCH_SPAN, export, read_trace

RECORD_KEYS = ("ing_hi", "accepted", "accept_term", "commit")
TRACE_FROM = 0.5  # share of the window's seconds after which the traced stretch starts
TRACE_TICKS = 40  # ticks in each traced stretch
STRETCHES = ("device", "host")  # the traced stretches' activities, in order
CAPTURE_AT = (0, 13, 26, 39)  # device stretch ticks whose kernel inputs the rooflines read
STATE_PLANES = tuple(rtick.State._fields)

Step = Callable  # (cfg, state, inbox, new_cmds, key) -> (state, inbox, rec)


def engine_config(conf: dict):
    from multiraft_tpu_torch.engine.core import EngineConfig

    return EngineConfig(
        G=conf["G"], P=conf["P"], L=conf["L"], E=conf["E"],
        INGEST=conf["INGEST"], HB_TICKS=conf["HB_TICKS"],
        ELECT_MIN=conf["ELECT_MIN"], ELECT_MAX=conf["ELECT_MAX"],
        use_kernels=conf["use_kernels"], prevote=conf["prevote"],
        check_quorum=conf["check_quorum"], membership=conf["membership"],
    )


def ref_config(conf: dict, G: int, commit_quorum: int = 0) -> rtick.Config:
    if conf["membership"] and not conf["use_kernels"]:
        raise NotImplementedError("the reference has no joint-consensus path")
    return rtick.Config(
        G=G, P=conf["P"], L=conf["L"], E=conf["E"], INGEST=conf["INGEST"],
        HB_TICKS=conf["HB_TICKS"], ELECT_MIN=conf["ELECT_MIN"],
        ELECT_MAX=conf["ELECT_MAX"], prevote=conf["prevote"],
        check_quorum=conf["check_quorum"], commit_quorum=commit_quorum,
    )


def program_step() -> Step:
    from multiraft_tpu_torch.engine import core

    def step(cfg, state, inbox, new_cmds, key):
        return core.run_ticks_traced_vec(cfg, state, inbox, 1, new_cmds, key)

    return step


def tick_key(base: rprng.Key, t: int) -> torch.Tensor:
    """The key of global tick ``t``, as the uint32 pair the engine takes."""
    return torch.tensor(rprng.fold_in(base, t), dtype=torch.uint32)


@dataclass
class Window:
    ticks: int = 0  # window ticks
    drain: int = 0  # drain ticks after it
    seconds: float = 0.0  # host clock, synchronised at both ends
    enqueue_s: float = 0.0  # host time in the calls into the tick loop
    enqueue_ticks: int = 0  # untraced window ticks that enqueue_s covers
    kill_s: float = 0.0  # host time enqueueing kills
    stretch_s: float = 0.0  # host time of the traced stretches, syncs included
    stretch_ticks: int = 0
    stretch_host_s: dict = field(default_factory=dict)  # the same, by stretch
    rounds: list = field(default_factory=list)  # (tick, groups, hit, event)


class Records:
    """Per-tick ``[rows, G]`` record planes, preallocated in chunks so that
    the window allocates nothing."""

    def __init__(self, G: int, rows: int, device) -> None:
        self.G, self.chunk, self.device = G, max(rows, 1), device
        self.chunks: List[Dict[str, torch.Tensor]] = []
        self._grow()

    def _grow(self) -> None:
        self.chunks.append({k: torch.empty((self.chunk, self.G), dtype=torch.int32,
                                           device=self.device)
                            for k in RECORD_KEYS})

    def put(self, t: int, rec: Dict[str, torch.Tensor]) -> None:
        c, r = divmod(t, self.chunk)
        while c >= len(self.chunks):
            self._grow()
        for k in RECORD_KEYS:
            self.chunks[c][k][r].copy_(rec[k][0])

    def stacked(self, n: int, key: str, cols=None) -> torch.Tensor:
        parts, left = [], n
        for ch in self.chunks:
            if left <= 0:
                break
            part = ch[key][: min(left, self.chunk)]
            parts.append(part if cols is None else part[:, cols])
            left -= self.chunk
        return torch.cat(parts)


class Clock:
    """A CUDA event after every tick and kill, against one start event."""

    def __init__(self, device, n: int) -> None:
        self.on = device.type == "cuda"
        self.events: List = []
        self.start = torch.cuda.Event(enable_timing=True) if self.on else None
        self._pool = [torch.cuda.Event(enable_timing=True) for _ in range(n)] if self.on else []

    def mark(self):
        if not self.on:
            return None
        ev = self._pool.pop() if self._pool else torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)
        return ev

    def ms(self) -> Optional[np.ndarray]:
        if not self.on:
            return None
        return np.array([self.start.elapsed_time(e) for e in self.events])


@dataclass
class Outcome:
    """What one run hands to the result line and to the readers."""

    cell: Cell
    window: Window
    setup_s: float
    memory_peak_bytes: Optional[int]
    writes: dict
    failover: Optional[dict]
    checks: Dict[str, dict]
    stretch: object = None  # traced with the device's activity alone
    host_stretch: object = None  # traced with the host's activity too
    card: str = ""  # name and power limit, as nvidia-smi reads them
    kind: str = ""  # torch.cuda.get_device_name()

    @property
    def correct(self) -> bool:
        return all(c["value"] <= c["limit"] for c in self.checks.values())

    @property
    def attempted(self) -> int:
        return self.writes["accepted_committed"] + self.writes["truncated"]

    @property
    def failed(self) -> int:
        unserved = self.failover["unserved"] if self.failover else 0
        return self.writes["truncated"] + unserved


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        step: Optional[Step] = None, process_start: Optional[float] = None,
        conf_override: Optional[dict] = None) -> Outcome:
    """One run on ``device``.  ``conf_override`` replaces keys of the
    configuration (the tests' small sizes); ``process_start`` is the
    ``perf_counter`` reading ``setup_s`` counts from."""
    t_proc = time.perf_counter() if process_start is None else process_start
    r = _Run(cell, seed, torch.device(device), step or program_step(),
             dict(cell.conf, **(conf_override or {})))
    r.setup(seconds, trace and r.on_card)
    setup_s = time.perf_counter() - t_proc
    r.window(seconds, trace and r.on_card)
    r.drain()
    memory_peak = r.program_peak()
    stretch, host_stretch = r.read_stretches()
    prog_state, prog_recs = r.sample_of_program()
    writes, fo = r.reduce()
    h = time.perf_counter()
    ref_state, ref_recs = replay(r.conf, r.mix, seed, r.sample, r.win.ticks, r.win.drain)
    checks = compare(prog_state, prog_recs, ref_state, ref_recs)
    log(f"cellbench: reference replayed {len(r.sample)} groups over "
        f"{r.t} ticks in {time.perf_counter() - h:.3f} s")
    return Outcome(cell=cell, window=r.win, setup_s=setup_s,
                   memory_peak_bytes=memory_peak, writes=writes, failover=fo,
                   checks=checks, stretch=stretch, host_stretch=host_stretch,
                   kind=torch.cuda.get_device_name(r.dev) if r.on_card else "cpu")


class _Run:
    """The program's side of one run, phase by phase."""

    def __init__(self, cell: Cell, seed: int, dev, step: Step, conf: dict) -> None:
        from multiraft_tpu_torch.engine.core import empty_mailbox, init_state

        self.dev, self.step, self.conf = dev, step, conf
        self.on_card = dev.type == "cuda"
        self.mix = traffic.load(cell.traffic_path)
        self.cfg = engine_config(conf)
        G = self.cfg.G
        self.base = rprng.key(traffic.key_seed(seed))
        self.victims = traffic.Victims(self.mix, G, seed) if self.mix.kill_every else None
        self.sample = traffic.sample(self.mix, G, seed, self.victims)
        self.cmds = torch.from_numpy(traffic.ingest(self.mix, G)).to(dev)
        if self.on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        self.st = init_state(self.cfg, torch.tensor(self.base, dtype=torch.uint32), dev)
        self.mb = empty_mailbox(self.cfg, dev)
        self.t = 0  # global tick
        self.prev: Optional[surgery.Killed] = None
        self.win = Window()
        self.prof = self.capture = self.kind = None  # the open stretch
        self.traced: Dict[str, str] = {}  # closed stretches' trace files, by kind

    def tick(self, cmds) -> dict:
        self.st, self.mb, rec = self.step(self.cfg, self.st, self.mb, cmds,
                                          tick_key(self.base, self.t))
        self.t += 1
        return rec

    def kill(self, groups) -> None:
        self.st, self.mb, self.prev = surgery.kill_leaders(self.st, self.mb, groups, self.prev)

    def setup(self, seconds: float, trace: bool = False) -> None:
        """Elect, fill with load (the fill's kill round included), and
        size the record buffers from the fill's pace.  Before a traced
        window, start and stop the profiler once: its first start takes
        seconds."""
        if trace:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]):
                torch.ones(1, device=self.dev).add_(1)
                _sync(self.dev)
        idle = torch.zeros_like(self.cmds)
        for _ in range(self.mix.boot_ticks):
            self.tick(idle)
        _sync(self.dev)
        t_fill = time.perf_counter()
        if self.victims is not None:
            self.kill(torch.from_numpy(self.victims.round(0)).to(self.dev))
        probe = Records(self.cfg.G, 1, self.dev)
        for _ in range(self.mix.fill_ticks):
            probe.put(0, self.tick(self.cmds))
        _sync(self.dev)
        per_tick = (time.perf_counter() - t_fill) / max(self.mix.fill_ticks, 1)
        self.C0 = self.st.commit.amax(dim=1)
        if self.on_card:
            self.setup_peak = torch.cuda.max_memory_allocated(self.dev)
            before = torch.cuda.memory_allocated(self.dev)
        cap = int(seconds / max(per_tick, 1e-4) * 1.5) + self.mix.drain_ticks + 64
        self.recs = Records(self.cfg.G, cap, self.dev)
        every = self.mix.kill_every
        self.clock = Clock(self.dev, cap + cap // max(every, 1) + 4)
        if self.victims is not None:  # every round the buffers can hold
            self.rounds = torch.from_numpy(np.stack(
                [self.victims.round(r) for r in range(cap // every + 2)])).to(self.dev)
        _sync(self.dev)
        if self.on_card:  # the benchmark's own buffers, held to the drain's end
            self.harness_bytes = torch.cuda.memory_allocated(self.dev) - before
            torch.cuda.reset_peak_memory_stats(self.dev)

    def window(self, seconds: float, trace: bool) -> None:
        win, every = self.win, self.mix.kill_every
        todo = list(STRETCHES) if trace else []
        began = None  # the window tick at which the open stretch began
        t0 = time.perf_counter()
        if self.clock.on:
            self.clock.start.record()
        w = 0
        try:
            while True:
                if self.prof is None and todo and time.perf_counter() - t0 >= TRACE_FROM * seconds:
                    began = w
                    self._start_stretch(todo.pop(0))
                if self.capture is not None:
                    self.capture.active = self.kind == "device" and (w - began) in CAPTURE_AT
                if self.victims is not None and w % every == 0:
                    r = 1 + w // every
                    g = self.rounds[r] if r < len(self.rounds) else \
                        torch.from_numpy(self.victims.round(r)).to(self.dev)
                    h = time.perf_counter()
                    with self._span("cellbench.kills"):
                        self.kill(g)
                        ev = self.clock.mark()
                    win.kill_s += time.perf_counter() - h
                    win.rounds.append((w, self.prev.groups, self.prev.hit, ev))
                h = time.perf_counter()
                with self._span("cellbench.tick"):
                    rec = self.tick(self.cmds)
                if self.prof is None:
                    win.enqueue_s += time.perf_counter() - h
                    win.enqueue_ticks += 1
                with self._span("cellbench.record"):
                    self.recs.put(w, rec)
                    self.clock.mark()
                w += 1
                if self.prof is not None and w == began + TRACE_TICKS:
                    self._stop_stretch()
                if time.perf_counter() - t0 >= seconds and self.prof is None and not todo:
                    break
        finally:
            if self.capture is not None:
                self.capture.remove()
        _sync(self.dev)
        win.seconds = time.perf_counter() - t0
        win.ticks = w

    def drain(self) -> None:
        for _ in range(self.mix.drain_ticks):
            self.recs.put(self.win.ticks + self.win.drain, self.tick(self.cmds))
            self.clock.mark()
            self.win.drain += 1
        _sync(self.dev)
        log(f"cellbench: window {self.win.ticks} ticks in {self.win.seconds:.3f} s, "
            f"drain {self.win.drain} ticks")

    def _span(self, name):
        if self.kind != "host":
            return contextlib.nullcontext()
        return torch.autograd.profiler.record_function(name)

    def _start_stretch(self, kind: str) -> None:
        """Trace the next ``TRACE_TICKS`` ticks: with the device's
        activity alone (``device``), capturing the kernels' inputs, or
        with the host's activity too (``host``), inside the stretch's
        span."""
        _sync(self.dev)
        self.kind = kind
        self.t_stretch = time.perf_counter()
        acts = [torch.profiler.ProfilerActivity.CUDA]
        if kind == "host":
            acts.insert(0, torch.profiler.ProfilerActivity.CPU)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        if kind == "host":
            self.stretch_span = torch.autograd.profiler.record_function(STRETCH_SPAN)
            self.stretch_span.__enter__()
        else:
            self.capture = _KernelCapture()
            self.capture.install()

    def _stop_stretch(self) -> None:
        _sync(self.dev)
        if self.kind == "host":
            self.stretch_span.__exit__(None, None, None)
        self.prof.stop()
        if self.kind == "device":
            self.capture.remove()
        self.traced[self.kind] = export(self.prof)
        took = time.perf_counter() - self.t_stretch
        self.win.stretch_s += took
        self.win.stretch_ticks += TRACE_TICKS
        self.win.stretch_host_s[self.kind] = took
        self.prof = self.kind = None

    def read_stretches(self):
        """The device stretch and the host stretch, read from their
        trace files; ``(None, None)`` in an untraced run."""
        if not self.traced:
            return None, None
        h = time.perf_counter()
        dev = read_trace(self.traced["device"], TRACE_TICKS, window="device")
        dev.kernel_calls = self.capture.calls
        host = read_trace(self.traced["host"], TRACE_TICKS, window="span")
        self.traced = {}
        w = self.win
        untraced = w.enqueue_s * 1e3 / max(w.enqueue_ticks, 1)
        log(f"cellbench: traces of 2 x {TRACE_TICKS} ticks (written out inside the window) "
            f"read in {time.perf_counter() - h:.3f} s; "
            f"ms a tick, host time / device window / device busy: device activity only "
            f"{w.stretch_host_s['device'] * 1e3 / TRACE_TICKS:.3f} / "
            f"{dev.window_s * 1e3 / TRACE_TICKS:.3f} / {dev.busy_s * 1e3 / TRACE_TICKS:.3f} "
            f"({len(dev.host_ops)} host events), with host activity "
            f"{w.stretch_host_s['host'] * 1e3 / TRACE_TICKS:.3f} / "
            f"{host.window_s * 1e3 / TRACE_TICKS:.3f} / {host.busy_s * 1e3 / TRACE_TICKS:.3f}; "
            f"untraced enqueue {untraced:.3f}")
        return dev, host

    def program_peak(self) -> Optional[int]:
        """The most device memory the program held: set-up's peak, or
        the window's and the drain's less the benchmark's record buffers,
        which are allocated between the two and held throughout."""
        if not self.on_card:
            return None
        raw = torch.cuda.max_memory_allocated(self.dev)
        peak = max(self.setup_peak, raw - self.harness_bytes)
        log(f"cellbench: device memory peak {peak} B held by the program; the benchmark's "
            f"record buffers {self.harness_bytes} B beside it, the process's peak "
            f"{max(raw, self.setup_peak)} B")
        return peak

    def sample_of_program(self):
        """The sampled groups' final state planes and per-tick records,
        on the host; then the program's state goes."""
        rows = torch.from_numpy(self.sample).to(self.dev)
        state = {f: getattr(self.st, f)[rows].cpu() if getattr(self.st, f).dim()
                 else getattr(self.st, f).cpu() for f in STATE_PLANES}
        total = self.win.ticks + self.win.drain
        recs = {k: self.recs.stacked(total, k, rows).cpu() for k in RECORD_KEYS}
        self.st = self.mb = None
        return state, recs

    def reduce(self):
        """The window's writes and the kills' time without service, from
        the records and the clock; then the records go."""
        h = time.perf_counter()
        win, recs = self.win, self.recs
        tick_ms, kill_ms = _split_marks(self.clock.ms(), win)
        writes = latency.writes(
            recs.stacked(win.ticks, "accepted"), recs.stacked(win.ticks, "ing_hi"),
            recs.stacked(win.ticks, "commit"), self.C0, tick_ms)
        fo = None
        if self.victims is not None:
            fo = latency.failover(
                recs.stacked(win.ticks + win.drain, "commit"),
                [(tk, g, hit, kill_ms[i] if kill_ms is not None else None)
                 for i, (tk, g, hit, _) in enumerate(win.rounds)],
                tick_ms, self.C0)
        log(f"cellbench: records reduced in {time.perf_counter() - h:.3f} s")
        if tick_ms is not None and win.ticks > 1:
            d = np.diff(tick_ms[: win.ticks])
            log("cellbench: device ms between tick ends p10/p50/p90/p99/max "
                + "/".join(f"{np.percentile(d, q):.3f}" for q in (10, 50, 90, 99, 100))
                + f"; share of the window in ticks over twice the median "
                f"{d[d > 2 * np.median(d)].sum() / d.sum():.4f}")
        self.recs = self.C0 = None
        if self.on_card:
            torch.cuda.empty_cache()
        return writes, fo


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _split_marks(T_ms, win: Window):
    """Per-tick and per-kill times (ms) out of the clock's marks, which
    interleave a kill's mark before its round's first tick."""
    if T_ms is None:
        return None, None
    kill_at = {tk for tk, *_ in win.rounds}
    tick_ms, kill_ms, i = [], [], 0
    for w in range(win.ticks + win.drain):
        if w in kill_at and w < win.ticks:
            kill_ms.append(T_ms[i])
            i += 1
        tick_ms.append(T_ms[i])
        i += 1
    return np.array(tick_ms), np.array(kill_ms)


class _KernelCapture:
    """A pass-through wrapper around the engine's two kernel entry points
    while the stretch is traced: it numbers every call and keeps the
    inputs of the calls made while ``active``, for the rooflines."""

    NAMES = ("quorum_commit", "vote_tally")

    def __init__(self) -> None:
        self.calls: Dict[str, list] = {n: [] for n in self.NAMES}
        self.count = {n: 0 for n in self.NAMES}
        self.active = False
        self._orig: Dict[str, Callable] = {}

    def install(self) -> None:
        from multiraft_tpu_torch.engine import kernels

        for name in self.NAMES:
            orig = getattr(kernels, name, None)
            if orig is None or name in self._orig:
                continue
            self._orig[name] = orig

            def wrapped(*args, _name=name, _orig=orig):
                if self.active:
                    self.calls[_name].append((self.count[_name], args))
                self.count[_name] += 1
                return _orig(*args)

            setattr(kernels, name, wrapped)

    def remove(self) -> None:
        from multiraft_tpu_torch.engine import kernels

        for name, orig in self._orig.items():
            setattr(kernels, name, orig)
        self._orig = {}


def replay(conf: dict, mix: traffic.Mix, seed: int, sample: np.ndarray,
           window_ticks: int, drain_ticks: int, commit_quorum: int = 0):
    """The reference's run of the sampled groups on the CPU, from the
    same inputs: returns its final state planes and its records of the
    window and the drain."""
    with torch.inference_mode():
        rows = torch.from_numpy(sample)
        rcfg = ref_config(conf, len(sample), commit_quorum)
        G = conf["G"]
        base = rprng.key(traffic.key_seed(seed))
        victims = traffic.Victims(mix, G, seed) if mix.kill_every else None
        local = {int(g): i for i, g in enumerate(sample)}
        cmds = torch.from_numpy(traffic.ingest(mix, G)[sample])
        idle = torch.zeros_like(cmds)
        st = rtick.init_state(rcfg, base, rows)
        mb = rtick.empty_mailbox(rcfg, rows.device)
        prev = None

        def kill(r):
            nonlocal st, mb, prev
            here = [local[int(g)] for g in victims.round(r) if int(g) in local]
            st, mb, prev = surgery.kill_leaders(
                st, mb, torch.tensor(here, dtype=torch.int64), prev)

        t = 0
        for _ in range(mix.boot_ticks):
            st, mb, _ = rtick.tick(rcfg, st, mb, idle, rprng.fold_in(rprng.fold_in(base, t), 0), rows)
            t += 1
        if victims is not None:
            kill(0)
        for _ in range(mix.fill_ticks):
            st, mb, _ = rtick.tick(rcfg, st, mb, cmds, rprng.fold_in(rprng.fold_in(base, t), 0), rows)
            t += 1
        out = {k: [] for k in RECORD_KEYS}
        for w in range(window_ticks + drain_ticks):
            if victims is not None and w < window_ticks and w % mix.kill_every == 0:
                kill(1 + w // mix.kill_every)
            st, mb, rec = rtick.tick(rcfg, st, mb, cmds, rprng.fold_in(rprng.fold_in(base, t), 0), rows)
            for k in RECORD_KEYS:
                out[k].append(rec[k])
            t += 1
        recs = {k: torch.stack(v) if v else torch.zeros((0, len(sample)), dtype=torch.int32)
                for k, v in out.items()}
        state = {f: getattr(st, f) for f in STATE_PLANES}
    return state, recs


def compare(prog_state, prog_recs, ref_state, ref_recs) -> Dict[str, dict]:
    """Values that differ between the program and the reference: in the
    sampled groups' final state planes, and in their per-tick records.
    Both limits are 0: the tick is integer arithmetic and the reference
    reproduces it exactly."""
    state_diff = 0
    for f in STATE_PLANES:
        a, b = prog_state[f], ref_state[f]
        if a.shape != b.shape:
            state_diff += max(a.numel(), b.numel())
        else:
            state_diff += int((a.to(torch.int64) != b.to(torch.int64)).sum())
    record_diff = 0
    for k in RECORD_KEYS:
        a, b = prog_recs[k], ref_recs[k]
        if a.shape != b.shape:
            record_diff += max(a.numel(), b.numel())
        else:
            record_diff += int((a.to(torch.int64) != b.to(torch.int64)).sum())
    return {"state_diff": {"value": state_diff, "limit": 0},
            "record_diff": {"value": record_diff, "limit": 0}}
