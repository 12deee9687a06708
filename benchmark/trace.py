"""The traced run: harness spans on the host and the device's operations
from torch.profiler, on one clock.

Spans are the benchmark's own, taken from outside the program around the
calls into each layer (`Spans.span`, `Spans.wrap`); they carry the number
of frames they cover. The profiler records CUDA activity only (kernels,
copies and sets on the card, and the host's launch calls); its
timestamps are nanoseconds on the wall clock, as `time.time_ns()` gives
them, so that a gap on the device can be laid against the span the host
was in.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

# the host span that explains an idle gap, innermost first: entropy
# inside result(), the encoder's run scheduler, mux + pack + send, and the
# wait for the camera's next frame
SPAN_ORDER = ("entropy", "result", "launch", "send", "source")


class Spans:
    """Host spans (name, start ns, end ns, frames)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.rows: list[tuple[str, int, int, int]] = []

    @contextlib.contextmanager
    def span(self, name: str, frames: int = 1):
        if not self.enabled:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.rows.append((name, t0, time.time_ns(), frames))

    def wrap(self, name: str, fn):
        """fn in a span of one frame."""
        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapped


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Tracer:
    """torch.profiler over the first `seconds` of the window: CUDA
    activity on a card; on the CPU (rehearsals) the host's operations,
    which leave the device's lists empty."""

    def __init__(self, enabled: bool, seconds: float, device):
        self.enabled = enabled
        self.cuda = device.type == "cuda"
        self.seconds = seconds
        self._prof = None
        self.t0 = self.t1 = None

    def start(self) -> None:
        """Start the profiler (in set-up: its first start takes seconds)."""
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[
            ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU])
        self._prof.__enter__()

    def begin(self) -> None:
        """Open the traced window."""
        if self._prof is not None:
            self.t0 = time.time_ns()

    def maybe_stop(self) -> None:
        if self._prof is not None and self.t1 is None and \
                time.time_ns() - self.t0 >= self.seconds * 1e9:
            self.stop()

    def stop(self) -> None:
        if self._prof is None or self.t1 is not None:
            return
        self.t1 = time.time_ns()
        self._prof.__exit__(None, None, None)

    def data(self, spans: Spans, context: dict) -> "TraceData | None":
        if self._prof is None:
            return None
        ops, api = [], []
        kinds: dict[str, int] = defaultdict(int)
        for e in self._prof.profiler.kineto_results.events():
            start = e.start_ns()
            end = start + e.duration_ns()
            name = e.name()
            if not str(e.device_type()).endswith("CUDA"):
                kinds["host"] += 1
                if "LaunchKernel" in name:
                    api.append(start)
                continue
            if getattr(e, "is_user_annotation", lambda: False)():
                kinds["annotation"] += 1
                continue
            kind = ("memcpy" if name.startswith("Memcpy") else
                    "memset" if name.startswith("Memset") else "kernel")
            kinds[kind] += 1
            ops.append((name, start, end, kind))
        self._prof = None
        return TraceData(self.t0, self.t1, ops, api, spans.rows, dict(kinds),
                         context)


class TraceData:
    """The traced window [t0, t1] (ns): the device's operations (name,
    start, end, kind), the launch calls' start times, the host spans and
    the cell's context (coded size and such) for the metric readers in
    benchmark/metrics/."""

    def __init__(self, t0, t1, ops, api, spans, kinds, context):
        self.t0, self.t1 = t0, t1
        self.window_s = (t1 - t0) / 1e9
        self.ops = [o for o in ops if o[2] > t0 and o[1] < t1]
        self.kernels = [o for o in self.ops if o[3] == "kernel"]
        self.api_launches = sum(1 for s in api if t0 <= s < t1)
        self.spans = [s for s in spans if t0 <= s[1] < t1]
        self.kinds = kinds
        self.context = context
        self.outside = len(ops) - len(self.ops)
        self._by_name = None

    def spans_of(self, name: str):
        return [s for s in self.spans if s[0] == name]

    def frames(self, name: str) -> int:
        return sum(s[3] for s in self.spans_of(name))

    def span_s(self, name: str) -> float:
        return sum(s[2] - s[1] for s in self.spans_of(name)) / 1e9

    def busy(self) -> list[tuple[int, int]]:
        return _union([(max(a, self.t0), min(b, self.t1))
                       for _, a, b, _ in self.ops])

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e9

    def gaps(self) -> list[tuple[int, int]]:
        out, t = [], self.t0
        for a, b in self.busy():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def host_span_at(self, t: int) -> str:
        """The innermost harness span the host was in at t ("loop"
        where none): spans of one name never overlap."""
        if self._by_name is None:
            self._by_name = {}
            for name in SPAN_ORDER:
                rows = sorted((s[1], s[2]) for s in self.spans_of(name))
                self._by_name[name] = ([a for a, _ in rows],
                                       [b for _, b in rows])
        for name in SPAN_ORDER:
            starts, ends = self._by_name[name]
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and ends[i] > t:
                return name
        return "loop"

    def lost(self) -> int | None:
        """Launch calls in the window that left no kernel event (F6), or
        None where the profiler recorded no launch calls."""
        if not self.api_launches:
            return None
        return max(0, self.api_launches - len(self.kernels))

    def breakdown(self) -> dict:
        by_op: dict[str, int] = defaultdict(int)
        for name, a, b, _ in self.ops:
            by_op[name[:120]] += min(b, self.t1) - max(a, self.t0)
        by_gap: dict[str, int] = defaultdict(int)
        for a, b in self.gaps():
            by_gap[self.host_span_at((a + b) // 2)] += b - a
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v / 1e9] for k, v in top],
                "idle_gaps": [[k, v / 1e9] for k, v in gaps]}

    def summary(self) -> str:
        return (f"trace window_s {self.window_s} device_ops {len(self.ops)} "
                f"kernels {len(self.kernels)} launch_calls "
                f"{self.api_launches} lost {self.lost()} outside "
                f"{self.outside} spans {len(self.spans)} kinds {self.kinds}")
