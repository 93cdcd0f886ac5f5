"""The traced run: torch.profiler over whole episodes, the harness's own
spans, and the reduction of the trace to device time.

The profiler records CPU and CUDA activity over ``trace_episodes``
episodes after one episode that warms it up (its events are dropped).
The harness opens one span at a time on the host, around what the loop
is doing: ``episode_start`` (the loop's set-up, up to the first
regulator call), ``regulator`` (the port's regulator call and the copy of
its move to the host) and ``plant_estimator`` (everything up to the next
regulator call: the plant, the estimator, the target selector, and at an
episode's end the trajectories' copy to the host).  The reduction takes
every device operation (kernel, copy, fill) of the profiled episodes,
their union on the device's timeline, the idle gaps between them, each
labelled by the harness span open on the host at the gap's middle, and
the K1/K2 launches by shape that the port counts.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

SPAN = "bench:"


@dataclasses.dataclass
class TraceReading:
    """What a traced run measured over its profiled episodes."""

    window_s: float            # first span's start to last span's end
    busy_s: float              # union of device operations in the window
    steps: int                 # closed-loop steps profiled (all plants at once)
    device_ops: dict           # name -> [count, seconds]
    gaps: list                 # [(label, seconds)] idle gaps, in time order
    ntt_shapes: dict           # ("ntt" | "intt", shape) -> launches


def union(intervals) -> list[tuple[float, float]]:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    out: list[list[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def reduce(spans, ops, window=None, ntt_shapes=None, steps=0) -> TraceReading:
    """spans: [(label, start_s, end_s)] host spans; ops: [(name, start_s,
    end_s)] device operations.  The window defaults to the spans' extent;
    operations are clipped to it."""
    spans = sorted(spans, key=lambda s: s[1])
    if window is None:
        window = (min(s[1] for s in spans), max(s[2] for s in spans))
    lo, hi = window
    clipped = [(max(a, lo), min(b, hi)) for _, a, b in ops if b > lo and a < hi]
    busy = union(clipped)
    by_name: dict = collections.defaultdict(lambda: [0, 0.0])
    for name, a, b in ops:
        by_name[name][0] += 1
        by_name[name][1] += b - a
    starts = [s[1] for s in spans]
    gaps = []
    edges = [lo] + [t for iv in busy for t in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = (a + b) / 2
            i = bisect.bisect_right(starts, mid) - 1
            label = spans[i][0] if i >= 0 and spans[i][2] >= mid else "none"
            gaps.append((label, b - a))
    return TraceReading(window_s=hi - lo, busy_s=sum(b - a for a, b in busy),
                        steps=steps, device_ops=dict(by_name), gaps=gaps,
                        ntt_shapes=dict(ntt_shapes or {}))


def breakdown(reading: TraceReading) -> dict:
    """The ten device operations with most time, and the idle gaps: their
    sum by host span first, then the longest single gaps."""
    top = sorted(reading.device_ops.items(), key=lambda kv: -kv[1][1])[:10]
    by_label: dict = collections.defaultdict(float)
    for label, s in reading.gaps:
        by_label[label] += s
    gaps = [[f"{label} (all gaps)", s] for label, s in
            sorted(by_label.items(), key=lambda kv: -kv[1])]
    longest = sorted(reading.gaps, key=lambda g: -g[1])
    gaps += [[f"{label} (longest)", s] for label, s in longest]
    return {"device_ops": [[name, s] for name, (_, s) in top],
            "idle_gaps": gaps[:10]}


def _is_device_op(evt) -> bool:
    """A device event that is an operation, not a range the profiler
    mirrors from the host onto the device's timeline."""
    return (str(getattr(evt, "device_type", "")).endswith("CUDA")
            and not getattr(evt, "is_user_annotation", False)
            and not evt.name.startswith((SPAN, "ProfilerStep")))


class Tracer:
    """torch.profiler over 1 + `episodes` episodes (the first warms it up)
    and the harness's spans while it records."""

    def __init__(self, episodes: int):
        import warnings

        from torch.profiler import ProfilerActivity, profile, schedule

        # one cycle is all it records: its note that a cycle's end clears
        # the events says nothing here
        warnings.filterwarnings("ignore", message=".*clears events.*")
        self.episodes = episodes
        self.done = 0
        self.events = None
        self._span = None
        self._prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=episodes, repeat=1),
            on_trace_ready=self._ready)
        self._prof.start()

    @property
    def recording(self) -> bool:
        return self.done <= self.episodes

    def span(self, label: str | None) -> None:
        """Close the open span and open `label` (None: open none)."""
        from torch.profiler import record_function

        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None
        if label is not None and self.recording:
            self._span = record_function(SPAN + label)
            self._span.__enter__()

    def end_episode(self) -> None:
        self.span(None)
        self._prof.step()
        self.done += 1
        if not self.recording:
            self._prof.stop()

    def _ready(self, prof) -> None:
        spans, ops = [], []
        for evt in prof.events():
            start, end = evt.time_range.start / 1e6, evt.time_range.end / 1e6
            if _is_device_op(evt):
                ops.append((evt.name, start, end))
            elif (evt.name.startswith(SPAN) and
                  str(getattr(evt, "device_type", "")).endswith("CPU")):
                spans.append((evt.name[len(SPAN):], start, end))
        self.events = (spans, ops)
