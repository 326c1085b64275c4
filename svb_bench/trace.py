"""The device trace of a ``--trace 1`` run, reduced to what the metrics
read: busy time from merged kernel intervals, device time by kernel name,
and the idle gaps between kernels named by what the host was doing.

The benchmark marks its own calls into the program with
``torch.profiler.record_function`` spans named ``SPAN_PREFIX + <layer>``;
the traced window is the span ``SPAN_PREFIX + "window"``."""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

SPAN_PREFIX = "svb_bench/"
WINDOW = SPAN_PREFIX + "window"
# the ResBlock cluster's kernels: the bf16 tensor-core convolution, its
# operand pre-pass and the float32 convolution
CLUSTER_KERNELS = ("resblock_conv1d", "lrelu_bf16")


def merge(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclass
class Trace:
    """Times in microseconds on the profiler's clock."""
    window: Tuple[float, float]
    kernels: List[Tuple[str, float, float]]          # name, start, end
    spans: List[Tuple[str, float, float]]            # harness spans
    host_ops: List[Tuple[str, float, float]] = field(default_factory=list)

    @classmethod
    def from_profile(cls, prof) -> "Trace":
        kernels, spans, host = [], [], []
        for e in prof.events():
            s, t = e.time_range.start, e.time_range.end
            if e.device_type.name == "CUDA":
                if not getattr(e, "is_user_annotation", False):
                    kernels.append((e.name, s, t))
            elif e.name.startswith(SPAN_PREFIX):
                spans.append((e.name[len(SPAN_PREFIX):], s, t))
            elif not getattr(e, "is_user_annotation", False):
                host.append((e.name, s, t))
        wins = [(s, t) for n, s, t in spans if n == "window"]
        if len(wins) != 1:
            raise RuntimeError(f"the trace holds {len(wins)} window spans, not 1")
        w = wins[0]
        return cls(window=w, spans=[x for x in spans if x[0] != "window"],
                   kernels=[k for k in kernels if k[2] > w[0] and k[1] < w[1]],
                   host_ops=host)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        w0, w1 = self.window
        return merge((max(s, w0), min(e, w1)) for _, s, e in self.kernels)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def kernel_seconds(self, keys: Tuple[str, ...]) -> float:
        """Summed durations of the kernels whose name holds one of ``keys``."""
        return sum(e - s for n, s, e in self.kernels if any(k in n for k in keys)) * 1e-6

    def device_ops(self, k: int = 10) -> List[List]:
        totals: Dict[str, float] = defaultdict(float)
        for n, s, e in self.kernels:
            totals[n] += (e - s) * 1e-6
        return [[n, t] for n, t in sorted(totals.items(), key=lambda r: -r[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """Idle time of the window by what the host was doing: the
        innermost harness span and the innermost host operation at each
        gap's midpoint (``python`` where none was running), summed by that
        name."""
        busy = self.busy_intervals()
        edges = [self.window[0]] + [x for iv in busy for x in iv] + [self.window[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        spans = sorted(self.spans, key=lambda r: r[1])
        ops = sorted(self.host_ops, key=lambda r: r[1])
        span_starts = [s for _, s, _ in spans]
        op_starts = [s for _, s, _ in ops]
        totals: Dict[str, float] = defaultdict(float)
        for s, e in gaps:
            mid = (s + e) / 2
            name = f"{_innermost(spans, span_starts, mid) or 'harness'}:" \
                   f"{_innermost(ops, op_starts, mid) or 'python'}"
            totals[name] += (e - s) * 1e-6
        return [[n, t] for n, t in sorted(totals.items(), key=lambda r: -r[1])[:k]]


def _innermost(events, starts, t, look_back: int = 256):
    """Name of the latest-starting event of ``events`` (sorted by start)
    that holds ``t``."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - look_back), -1):
        name, s, e = events[j]
        if e >= t:
            return name
    return None
