"""One run of one cell: set-up, the measured window, the drain, the
reference's check and the metrics.

The program under test is ``multiraft_tpu_torch``: the window calls
``engine.core.run_ticks_traced_vec`` one tick at a time, with the
configuration's kernels on, and records a CUDA event after each tick
without synchronising, so the host stays ahead of the device and every
tick has a device timestamp.  The mix's events (:mod:`.events`, such as
leader kills) are enqueued between ticks.  After the window the drain
runs a few more ticks without new events, so that the window's last
victims can be served again; nothing of the drain counts towards
``writes_per_s``.  ``attempted`` and ``failed`` are counted over the
mix's fixed span of window ticks (:class:`.traffic.Count`).

A traced run traces two stretches of the window back to back: the first
with the device's activity alone, from which the device's busy and idle
time, the launches and the kernels' times are read; the second with the
host's activity too, which slows the host, for the breakdown of the
device's idle time by what the host was doing.  Tracing takes seconds of
the window, so a traced run, which reports no end-to-end metric, holds
its window open until it has run the failure count's ticks.

Once the drain has ended and the peak memory is read, the program's
state is freed and the configuration's reference (``cellbench/reference/
<name>.py``, :mod:`.reference.tick` by default) replays a sample of
groups, drawn from the seed, from the same inputs: its final state and
its per-tick records have to equal the program's, value for value.

:func:`run` takes the device and may take another ``step`` in place of
the program's; the command line (:mod:`.run`) passes the card only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import latency, manifest, traffic
from .isolation import program_imports
from .manifest import Cell
from .reference import prng as rprng
from .trace import STRETCH_SPAN, export, read_trace

TRACE_FROM = 0.5  # share of the window's seconds after which the traced stretch starts
TRACE_TICKS = 40  # ticks in each traced stretch
STRETCHES = ("device", "host")  # the traced stretches' activities, in order
CAPTURE_AT = (0, 13, 26, 39)  # device stretch ticks whose kernel inputs the rooflines read
REQUIRED = ("G", "P", "L", "E", "INGEST", "HB_TICKS", "ELECT_MIN", "ELECT_MAX",
            "use_kernels", "prevote", "check_quorum", "membership")

Step = Callable  # (cfg, state, inbox, new_cmds, key) -> (state, inbox, rec)


def engine_config(conf: dict):
    """The program's ``EngineConfig`` from every key of the configuration
    that names one of its fields; the :data:`REQUIRED` keys must be
    there, keys that name no field are left out."""
    from multiraft_tpu_torch.engine.core import EngineConfig

    missing = [k for k in REQUIRED if k not in conf]
    if missing:
        raise KeyError(f"the configuration lacks {missing}")
    names = {f.name for f in dataclasses.fields(EngineConfig)}
    return EngineConfig(**{k: v for k, v in conf.items() if k in names})


def reference(conf: dict):
    """The configuration's reference module (``"reference"``, default
    ``tick``) under ``cellbench/reference/``."""
    return manifest.module("reference", conf.get("reference", "tick"))


def events_of(mix: traffic.Mix, G: int, seed: int):
    """The mix's events, planned from the seed; None without events."""
    if mix.events is None:
        return None
    return manifest.module("events", mix.events).plan(mix.event_params, G, seed)


def events_apply_reference(mix: traffic.Mix, events):
    """The function that applies the events to the reference's state:
    ``apply_reference``, or ``apply`` where the event module imports
    nothing of the program (:func:`.isolation.program_imports`)."""
    if events is None:
        return None
    if hasattr(events, "apply_reference"):
        return events.apply_reference
    path = manifest.ROOT / "events" / f"{mix.events}.py"
    bad = program_imports(path, f"cellbench.events.{mix.events}")
    if bad:
        raise ImportError(f"{path} imports the program ({bad}) and gives no "
                          f"apply_reference for the reference's side")
    return events.apply


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
    event_s: float = 0.0  # host time enqueueing events
    stretch_s: float = 0.0  # host time of the traced stretches, syncs included
    stretch_ticks: int = 0
    stretch_host_s: dict = field(default_factory=dict)  # the same, by stretch
    rounds: list = field(default_factory=list)  # (tick, rows, hit, clock event); rows None: no loss


class Records:
    """Per-tick ``[rows, G]`` record planes, preallocated in chunks so that
    the window allocates nothing."""

    def __init__(self, G: int, rows: int, device, keys) -> None:
        self.G, self.chunk, self.device, self.keys = G, max(rows, 1), device, tuple(keys)
        self.chunks: List[Dict[str, torch.Tensor]] = []
        self._grow()

    def _grow(self) -> None:
        self.chunks.append({k: torch.empty((self.chunk, self.G), dtype=torch.int32,
                                           device=self.device)
                            for k in self.keys})

    def put(self, t: int, rec: Dict[str, torch.Tensor]) -> None:
        c, r = divmod(t, self.chunk)
        while c >= len(self.chunks):
            self._grow()
        for k in self.keys:
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
    """A CUDA event after every tick and event round, against one start event."""

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
    count: dict  # the failure count over the mix's span (_Run.count)
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
        """Entries accepted in the count's span that ended committed or
        truncated."""
        return self.count["committed"] + self.count["truncated"]

    @property
    def failed(self) -> int:
        """Of those, the truncated ones, and the span's event rounds'
        losses of service not made good by the count's last tick."""
        return self.count["truncated"] + self.count["unserved"]


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
    writes, fo, count = r.reduce()
    h = time.perf_counter()
    ref_state, ref_recs = replay(r.conf, r.mix, seed, r.sample, r.win.ticks, r.win.drain)
    checks = compare(prog_state, prog_recs, ref_state, ref_recs)
    log(f"cellbench: reference replayed {len(r.sample)} groups over "
        f"{r.t} ticks in {time.perf_counter() - h:.3f} s")
    return Outcome(cell=cell, window=r.win, setup_s=setup_s,
                   memory_peak_bytes=memory_peak, writes=writes, failover=fo,
                   count=count, checks=checks, stretch=stretch, host_stretch=host_stretch,
                   kind=torch.cuda.get_device_name(r.dev) if r.on_card else "cpu")


class _Run:
    """The program's side of one run, phase by phase."""

    def __init__(self, cell: Cell, seed: int, dev, step: Step, conf: dict) -> None:
        from multiraft_tpu_torch.engine.core import empty_mailbox, init_state

        self.dev, self.step, self.conf = dev, step, conf
        self.on_card = dev.type == "cuda"
        self.mix = traffic.load(cell.traffic_path)
        self.count_span = traffic.Count.load(cell.count_path)
        self.ref = reference(conf)
        self.cfg = engine_config(conf)
        G = self.cfg.G
        self.base = rprng.key(traffic.key_seed(seed))
        self.events = events_of(self.mix, G, seed)
        self.sample = traffic.sample(self.mix, G, seed, self.events)
        self.cmds = torch.from_numpy(traffic.ingest(self.mix, G)).to(dev)
        if self.on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        self.st = init_state(self.cfg, torch.tensor(self.base, dtype=torch.uint32), dev)
        self.mb = empty_mailbox(self.cfg, dev)
        self.t = 0  # global tick
        self.carry = None  # what the last event round returned
        self.win = Window()
        self.prof = self.capture = self.kind = None  # the open stretch
        self.traced: Dict[str, str] = {}  # closed stretches' trace files, by kind
        self.stretch_at: Dict[str, int] = {}  # each stretch's first window tick, by kind

    def tick(self, cmds) -> dict:
        self.st, self.mb, rec = self.step(self.cfg, self.st, self.mb, cmds,
                                          tick_key(self.base, self.t))
        self.t += 1
        return rec

    def event(self, r: int) -> None:
        rows = self.rounds[r] if r < len(self.rounds) else \
            torch.from_numpy(self.events.rows(r)).to(self.dev)
        self.st, self.mb, self.carry = self.events.apply(self.st, self.mb, rows, rows, self.carry)

    def setup(self, seconds: float, trace: bool = False) -> None:
        """Elect, fill with load (the fill's event round included), and
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
        self.rounds: List[torch.Tensor] = []
        if self.events is not None:
            self.event(0)
        probe = Records(self.cfg.G, 1, self.dev, self.ref.RECORD_KEYS)
        for _ in range(self.mix.fill_ticks):
            probe.put(0, self.tick(self.cmds))
        _sync(self.dev)
        per_tick = (time.perf_counter() - t_fill) / max(self.mix.fill_ticks, 1)
        self.C0 = self.st.commit.amax(dim=1)
        if self.on_card:
            self.setup_peak = torch.cuda.max_memory_allocated(self.dev)
            before = torch.cuda.memory_allocated(self.dev)
        cap = max(int(seconds / max(per_tick, 1e-4) * 1.5),
                  self.count_span.ticks if trace else 0) + self.mix.drain_ticks + 64
        self.recs = Records(self.cfg.G, cap, self.dev, self.ref.RECORD_KEYS)
        every = self.events.every if self.events is not None else 0
        self.clock = Clock(self.dev, cap + cap // max(every, 1) + 4)
        if self.events is not None:  # every round the buffers can hold
            self.rounds = [torch.from_numpy(self.events.rows(r)).to(self.dev)
                           for r in range(cap // every + 2)]
        _sync(self.dev)
        if self.on_card:  # the benchmark's own buffers, held to the drain's end
            self.harness_bytes = torch.cuda.memory_allocated(self.dev) - before
            torch.cuda.reset_peak_memory_stats(self.dev)

    def window(self, seconds: float, trace: bool) -> None:
        win, events = self.win, self.events
        todo = list(STRETCHES) if trace else []
        least = self.count_span.ticks if trace else 0  # a traced window's fewest ticks
        began = None  # the window tick at which the open stretch began
        t0 = time.perf_counter()
        if self.clock.on:
            self.clock.start.record()
        w = 0
        try:
            while True:
                if self.prof is None and todo and time.perf_counter() - t0 >= TRACE_FROM * seconds:
                    began = self.stretch_at[todo[0]] = w
                    self._start_stretch(todo.pop(0))
                if self.capture is not None:
                    self.capture.active = self.kind == "device" and (w - began) in CAPTURE_AT
                if events is not None and w % events.every == 0:
                    h = time.perf_counter()
                    with self._span("cellbench.events"):
                        self.event(1 + w // events.every)
                        ev = self.clock.mark()
                    win.event_s += time.perf_counter() - h
                    rows, hit = events.lost(self.carry) or (None, None)
                    win.rounds.append((w, rows, hit, ev))
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
                if time.perf_counter() - t0 >= seconds and self.prof is None and not todo \
                        and w >= least:
                    break
        finally:
            if self.capture is not None:
                self.capture.remove()
        _sync(self.dev)
        win.seconds = time.perf_counter() - t0
        win.ticks = w
        if least and w == least:
            log(f"cellbench: the traced window ran on to {w} ticks, the failure count's")

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
        tick_ms, _ = _split_marks(self.clock.ms(), w)
        by_events = {}  # each stretch's ms a tick between the CUDA events at its ticks' ends
        for kind, b in self.stretch_at.items():
            by_events[kind] = (tick_ms[b + TRACE_TICKS - 1] - tick_ms[b]) / (TRACE_TICKS - 1)
        log(f"cellbench: traces of 2 x {TRACE_TICKS} ticks (written out inside the window) "
            f"read in {time.perf_counter() - h:.3f} s; "
            f"ms a tick, host time / device window / device busy: device activity only "
            f"{w.stretch_host_s['device'] * 1e3 / TRACE_TICKS:.3f} / "
            f"{dev.window_s * 1e3 / TRACE_TICKS:.3f} / {dev.busy_s * 1e3 / TRACE_TICKS:.3f} "
            f"({len(dev.host_ops)} host events), with host activity "
            f"{w.stretch_host_s['host'] * 1e3 / TRACE_TICKS:.3f} / "
            f"{host.window_s * 1e3 / TRACE_TICKS:.3f} / {host.busy_s * 1e3 / TRACE_TICKS:.3f}; "
            f"untraced enqueue {untraced:.3f}; the same ticks between the harness's CUDA events, "
            f"device activity only {by_events['device']:.3f}, with host activity "
            f"{by_events['host']:.3f}")
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
        """The sampled groups' final state planes (those of the reference's
        ``State``) and per-tick records, on the host; then the program's
        state goes."""
        rows = torch.from_numpy(self.sample).to(self.dev)
        state = {f: getattr(self.st, f)[rows].cpu() if getattr(self.st, f).dim()
                 else getattr(self.st, f).cpu() for f in self.ref.State._fields}
        total = self.win.ticks + self.win.drain
        recs = {k: self.recs.stacked(total, k, rows).cpu() for k in self.recs.keys}
        self.st = self.mb = None
        return state, recs

    def reduce(self):
        """The window's writes, the event rounds' time without service and
        the failure count, from the records and the clock; then the
        records go."""
        h = time.perf_counter()
        win, recs = self.win, self.recs
        tick_ms, event_ms = _split_marks(self.clock.ms(), win)
        writes = latency.writes(
            recs.stacked(win.ticks, "accepted"), recs.stacked(win.ticks, "ing_hi"),
            recs.stacked(win.ticks, "commit"), self.C0, tick_ms)
        losses = [(tk, g, hit, event_ms[i] if event_ms is not None else None)
                  for i, (tk, g, hit, _) in enumerate(win.rounds) if g is not None]
        fo = None
        if losses:
            fo = latency.failover(recs.stacked(win.ticks + win.drain, "commit"),
                                  losses, tick_ms, self.C0)
        count = self.count(losses)
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
        return writes, fo, count

    def count(self, losses) -> dict:
        """``attempted`` and ``failed`` over the mix's span
        (:class:`.traffic.Count`): entries accepted in the span's window
        ticks and the losses of service of the rounds begun in them, all
        judged at the end of the span's outcome ticks.  A window too short
        for the whole span counts the part it covers and says so."""
        want, after = self.count_span.window_ticks, self.count_span.outcome_ticks
        span = min(want, max(self.win.ticks - after, 0))
        judge = min(span + after, self.win.ticks)
        if span < want:
            log(f"cellbench: the window's {self.win.ticks} ticks cover {span} of the failure "
                f"count's {want} (+{after} to judge them): attempted and failed count those")
        out = {"span": span, "judged_at": judge, "committed": 0, "truncated": 0, "unserved": 0}
        if span:
            C = self.recs.stacked(judge, "commit")
            out.update(latency.settled(self.recs.stacked(judge, "accepted"),
                                       self.recs.stacked(judge, "ing_hi"), C, span))
            counted = [(tk, g, hit, None) for tk, g, hit, _ in losses if tk < span]
            if counted:
                out["unserved"] = latency.failover(C, counted, None, self.C0)["unserved"]
        return out


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _split_marks(T_ms, win: Window):
    """Per-tick and per-round times (ms) out of the clock's marks, which
    interleave an event round's mark before the round's first tick."""
    if T_ms is None:
        return None, None
    round_at = {tk for tk, *_ in win.rounds}
    tick_ms, round_ms, i = [], [], 0
    for w in range(win.ticks + win.drain):
        if w in round_at and w < win.ticks:
            round_ms.append(T_ms[i])
            i += 1
        tick_ms.append(T_ms[i])
        i += 1
    return np.array(tick_ms), np.array(round_ms)


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
    ref = reference(conf)
    with torch.inference_mode():
        rows = torch.from_numpy(sample)
        rcfg = ref.config(conf, len(sample), commit_quorum)
        G = conf["G"]
        base = rprng.key(traffic.key_seed(seed))
        events = events_of(mix, G, seed)
        local = {int(g): i for i, g in enumerate(sample)}
        cmds = torch.from_numpy(traffic.ingest(mix, G)[sample])
        idle = torch.zeros_like(cmds)
        st = ref.init_state(rcfg, base, rows)
        mb = ref.empty_mailbox(rcfg, rows.device)
        carry = None
        apply = events_apply_reference(mix, events)

        def event(r):
            nonlocal st, mb, carry
            here = [int(g) for g in events.rows(r) if int(g) in local]
            st, mb, carry = apply(st, mb, torch.tensor([local[g] for g in here], dtype=torch.int64),
                                  torch.tensor(here, dtype=torch.int64), carry)

        def tick(st, mb, cmds, t):
            return ref.tick(rcfg, st, mb, cmds, rprng.fold_in(rprng.fold_in(base, t), 0), rows)

        t = 0
        for _ in range(mix.boot_ticks):
            st, mb, _ = tick(st, mb, idle, t)
            t += 1
        if events is not None:
            event(0)
        for _ in range(mix.fill_ticks):
            st, mb, _ = tick(st, mb, cmds, t)
            t += 1
        out = {k: [] for k in ref.RECORD_KEYS}
        for w in range(window_ticks + drain_ticks):
            if events is not None and w < window_ticks and w % events.every == 0:
                event(1 + w // events.every)
            st, mb, rec = tick(st, mb, cmds, t)
            for k in ref.RECORD_KEYS:
                out[k].append(rec[k])
            t += 1
        recs = {k: torch.stack(v) if v else torch.zeros((0, len(sample)), dtype=torch.int32)
                for k, v in out.items()}
        state = {f: getattr(st, f) for f in ref.State._fields}
    return state, recs


def compare(prog_state, prog_recs, ref_state, ref_recs) -> Dict[str, dict]:
    """Values that differ between the program and the reference: in the
    sampled groups' final state planes, and in their per-tick records.
    Both limits are 0: the tick is integer arithmetic and the reference
    reproduces it exactly."""
    state_diff = 0
    for f in ref_state:
        a, b = prog_state[f], ref_state[f]
        if a.shape != b.shape:
            state_diff += max(a.numel(), b.numel())
        else:
            state_diff += int((a.to(torch.int64) != b.to(torch.int64)).sum())
    record_diff = 0
    for k in ref_recs:
        a, b = prog_recs[k], ref_recs[k]
        if a.shape != b.shape:
            record_diff += max(a.numel(), b.numel())
        else:
            record_diff += int((a.to(torch.int64) != b.to(torch.int64)).sum())
    return {"state_diff": {"value": state_diff, "limit": 0},
            "record_diff": {"value": record_diff, "limit": 0}}
