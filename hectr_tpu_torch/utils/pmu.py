"""Per-section timing -- the libpmu TEST_DO/TEST_DONE equivalent, as
``hectr_tpu/utils/pmu.py`` -- and the port's spans.

The reference brackets keygen, rotation keygen and the closed loop with
libpmu macros (src/ctr.c:528-533,570,597).  Here a section waits for the
CUDA device before it starts and before it stops (where the JAX package
calls jax.effects_barrier), so asynchronous launches are not left out,
and can capture a torch.profiler trace for perfetto.

``span(name)`` marks a piece of the port's work (the closed loop's
stages, each scheme op, the gemv's and the key switch's parts).  With
nothing listening it costs two flag reads.  While a torch profiler
records, it opens ``record_function("hectr." + name)``: the range sits on
the profiler's clock, and each launch made inside it carries its
correlation id, so ``by_span`` can split a trace's device time, launches
and idle gaps by span.  Inside ``recording()`` it keeps its start and
end on the host clock, without the profiler.

``count(name)`` adds one to ``COUNTS[name]``: how often a path was taken
(the CUDA-graph captures, replays and uncaptured calls of the regulator,
``regulator.*``, and of the closed loop's stages, ``loop.*``), as the
kernels' wrappers count their launches.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import pathlib
import sys
import time

import torch

PREFIX = "hectr."
TOP = 5                    # operations ``by_span`` names for each span

# torch's own flag, a plain module global: True while a profiler records
# (set when its trace starts, so False in a schedule's warm-up)
_profiler = torch.autograd.profiler
_recording = None          # the open ``Recording``, if any
_clock = time.perf_counter_ns
COUNTS: collections.Counter = collections.Counter()


def _profile():
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Accumulates named section timings; prints each to stderr."""

    def __init__(self):
        self.sections: dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, label: str, trace_dir: str | None = None):
        """Time the body; with `trace_dir`, also write a torch.profiler
        Chrome trace of it there (``<label>.json``), the port's spans
        among its ranges."""
        with (_profile() if trace_dir else contextlib.nullcontext()) as prof:
            _sync()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                _sync()
                dt = time.perf_counter() - t0
                self.sections[label] = self.sections.get(label, 0.0) + dt
                print(f"[pmu] {label}: {dt:.3f}s", file=sys.stderr)
        if prof is not None:
            out = pathlib.Path(trace_dir)
            out.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(out / f"{label}.json"))

    def report(self) -> dict[str, float]:
        return dict(self.sections)


@contextlib.contextmanager
def timed(label: str):
    """One-off section timer (TEST_DO(label) ... TEST_DONE parity)."""
    with Timer().section(label):
        yield


def count(name: str) -> None:
    """One more of the event `name` in ``COUNTS``."""
    COUNTS[name] += 1


def reset_counts() -> None:
    COUNTS.clear()


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


class _Off:
    """What ``span`` returns with nothing listening: enters nothing.  One
    per name, so that a call allocates nothing."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _spanned(self.name, fn)


_OFF: dict[str, _Off] = {}


class _On(_Off):
    """A span while a profiler records or a recording is open."""

    __slots__ = ("step", "_range", "_rec", "_entry")

    def __init__(self, name: str, step):
        self.name, self.step = name, step
        self._range = self._rec = self._entry = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            args = None if self.step is None else str(self.step)
            self._range = torch.autograd.profiler.record_function(
                PREFIX + self.name, args)
            self._range.__enter__()
        self._rec = _recording
        if self._rec is not None:
            self._entry = self._rec._open(self.name, self.step)
        return None

    def __exit__(self, *exc):
        if self._entry is not None:
            self._rec._close(self._entry)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span(name: str, step: int | None = None):
    """The span `name` ("hectr." + name on the profiler's timeline), as a
    context manager, or as a decorator of a function whose every call it
    spans.  `step`, the closed loop's step index, goes with the range
    (its args) and with every span the recording keeps inside it."""
    if _recording is None and not _profiler._is_profiler_enabled:
        off = _OFF.get(name)
        if off is None:
            off = _OFF[name] = _Off(name)
        return off
    return _On(name, step)


class _Silent:
    _is_profiler_enabled = False


@contextlib.contextmanager
def muted():
    """Spans open no range inside, even while a profiler records (to price
    the ranges: the same profiled work with and without them)."""
    global _profiler
    _profiler = _Silent
    try:
        yield
    finally:
        _profiler = torch.autograd.profiler


def _spanned(name: str, fn):
    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        if _recording is None and not _profiler._is_profiler_enabled:
            return fn(*args, **kwargs)
        with _On(name, None):
            return fn(*args, **kwargs)
    return spanned


class Recording:
    """The spans made while ``recording()`` was open: ``spans`` holds
    [name, parent (an index into spans, or -1), start_ns, end_ns, step]
    in the order they opened; ``table`` (set when the recording closes)
    maps each name to its calls and its total and self host ms (self:
    the duration less the time its child spans cover)."""

    def __init__(self):
        self.spans: list[list] = []
        self.table: dict[str, dict] = {}
        self._open_ix: list[int] = []

    def _open(self, name: str, step) -> list:
        parent = self._open_ix[-1] if self._open_ix else -1
        if step is None and parent >= 0:
            step = self.spans[parent][4]
        entry = [name, parent, _clock(), None, step]
        self._open_ix.append(len(self.spans))
        self.spans.append(entry)
        return entry

    def _close(self, entry: list) -> None:
        entry[3] = _clock()
        self._open_ix.pop()

    def _tabulate(self) -> None:
        child_ns = collections.Counter()
        for _, parent, start, end, _ in self.spans:
            if parent >= 0 and end is not None:
                child_ns[parent] += end - start
        table: dict = collections.defaultdict(
            lambda: {"calls": 0, "total_ms": 0.0, "self_ms": 0.0})
        for i, (name, _, start, end, _) in enumerate(self.spans):
            if end is None:
                continue
            row = table[name]
            row["calls"] += 1
            row["total_ms"] += (end - start) / 1e6
            row["self_ms"] += (end - start - child_ns[i]) / 1e6
        self.table = dict(table)

    def lines(self, steps: int = 1) -> list[str]:
        """The table by self time, per step over `steps`."""
        rows = sorted(self.table.items(), key=lambda kv: -kv[1]["self_ms"])
        return [f"{name:28s} {r['calls'] / steps:8.2f} calls "
                f"{r['total_ms'] / steps:9.4f} total ms "
                f"{r['self_ms'] / steps:9.4f} self ms" for name, r in rows]


@contextlib.contextmanager
def recording():
    """Keep every span made inside on the host clock (no profiler needed);
    yields the ``Recording``, whose ``table`` is filled when it closes.
    One recording at a time."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a recording is already open")
    rec = _recording = Recording()
    try:
        yield rec
    finally:
        _recording = None
        rec._tabulate()


# ---------------------------------------------------------------------------
# a profiler trace by span
# ---------------------------------------------------------------------------


def _on(evt, kind: str) -> bool:
    return str(getattr(evt, "device_type", "")).endswith(kind)


def is_device_op(evt) -> bool:
    """A device event (or ``key_averages()`` row) that is an operation
    (kernel, copy, fill), not a range the profiler mirrors from the host
    onto the device's timeline (a user annotation)."""
    return (_on(evt, "CUDA") and not getattr(evt, "is_user_annotation", False)
            and not evt.key.startswith((PREFIX, "ProfilerStep")))


def _union(intervals) -> list[list[float]]:
    out: list[list[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _innermost(ranges, times) -> list:
    """For each time in `times`, the name of the innermost range of
    `ranges` ([(start, end, name)], nested as one thread opens them) open
    at it, or "none"."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    order = sorted(range(len(times)), key=times.__getitem__)
    out = ["none"] * len(times)
    stack: list = []
    i = 0
    for j in order:
        t = times[j]
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            out[j] = stack[-1][2]
    return out


def by_span(events, steps: int) -> dict:
    """A profiler trace (``prof.events()``: times in us) by the port's
    spans, per step over `steps`: each device operation's time and launch
    goes to the innermost span open on the host when its launch was made
    (the CUDA runtime call with the operation's correlation id), and each
    span names its TOP operations by device time; operations whose launch
    is not in the trace are counted as unmatched.  The idle gaps between
    the device operations, within the spans' extent, each go to the
    innermost span open at its middle ("none" where no span is open)."""
    ranges, ops = [], collections.defaultdict(list)
    for evt in events:
        if is_device_op(evt):
            ops[evt.id].append((evt.time_range.start, evt.time_range.end,
                                evt.name))
        elif _on(evt, "CPU") and evt.name.startswith(PREFIX):
            ranges.append((evt.time_range.start, evt.time_range.end,
                           evt.name[len(PREFIX):]))
    busy = _union((a, b) for ivs in ops.values() for a, b, _ in ivs)
    launches = [(evt.time_range.start, evt.id) for evt in events
                if _on(evt, "CPU") and evt.name.startswith("cu")
                and evt.id in ops]
    device = collections.defaultdict(
        lambda: collections.defaultdict(lambda: [0.0, 0]))
    for name, (_, cid) in zip(_innermost(ranges, [t for t, _ in launches]),
                              launches):
        for start, end, op in ops.pop(cid, ()):
            device[name][op][0] += end - start
            device[name][op][1] += 1
    spans = ranges or [(a, b, "") for a, b in busy]
    lo, hi = (min(r[0] for r in spans), max(r[1] for r in spans)) \
        if spans else (0.0, 0.0)
    edges = [lo] + [min(max(t, lo), hi) for iv in busy for t in iv] + [hi]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    idle = collections.Counter()
    for name, (a, b) in zip(_innermost(ranges, [(a + b) / 2 for a, b in gaps]),
                            gaps):
        idle[name] += b - a
    left = [(a, b) for ivs in ops.values() for a, b, _ in ivs]

    def row(by_op):
        longest = sorted(by_op.items(), key=lambda kv: -kv[1][0])[:TOP]
        return {"device_ms_per_step": sum(us for us, _ in by_op.values())
                / 1e3 / steps,
                "launches_per_step": sum(n for _, n in by_op.values()) / steps,
                "top": [[op, us / 1e3 / steps, n / steps]
                        for op, (us, n) in longest]}
    return {
        "by_span": {name: row(v) for name, v in sorted(device.items())},
        "unmatched_launches_per_step": len(left) / steps,
        "unmatched_device_ms_per_step":
            sum(b - a for a, b in left) / 1e3 / steps,
        "idle_ms_per_step": {name: us / 1e3 / steps
                             for name, us in idle.most_common()},
        "window_ms_per_step": (hi - lo) / 1e3 / steps,
    }
