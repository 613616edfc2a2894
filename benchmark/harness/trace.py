"""Spans around the harness's calls into the program, and the device
trace of a ``--trace 1`` run.

Every span is an interval of the host's wall clock (``time.time_ns``)
kept in memory. The traced window records the device's activity alone
(``torch.profiler`` with CUDA activity only: no CPU operator is
recorded, so the host's own work runs at nearly its untraced speed) and
is read in memory, never from a file. The trace stamps device events on
the same wall clock; a marker corrects what offset remains: after a
sync, one fill of a float tensor is launched before the window opens,
and the start of the fill kernel nearest its launch, minus the host's
clock at the launch, is the offset. (The profiler may also hand back
device events from just before it started; the window's bounds clip
them.) The device's busy time is the union of its kernel, copy and set
intervals inside the window; each idle gap is charged to the innermost
harness span open at its middle.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time

import torch

WINDOW = "window"
MARKER_KERNEL = "FillFunctor<float>"
MARKER_SLACK_NS = 50_000_000


class Tracer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.host: dict[str, list[float]] = collections.defaultdict(list)
        self.intervals: list[tuple[int, int, str]] = []
        self.summary: dict | None = None

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        yield
        t1 = time.time_ns()
        self.host[name].append((t1 - t0) / 1e9)
        if self.enabled:
            self.intervals.append((t0, t1, name))

    def warm(self) -> None:
        """A short profile, so that the tracer's own start-up (CUPTI) is
        paid in set-up and not in the window."""
        if not self.enabled:
            return
        with _profile():
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def window(self):
        """The measured window: profiled where tracing is on."""
        if not self.enabled:
            yield
            return
        torch.cuda.synchronize()
        prof = _profile()
        prof.start()
        marker = torch.empty(1, device="cuda")
        torch.cuda.synchronize()
        h0 = time.time_ns()
        marker.fill_(1.0)
        h1 = time.time_ns()
        torch.cuda.synchronize()
        self.intervals = []
        w0 = time.time_ns()
        try:
            yield
        finally:
            torch.cuda.synchronize()
            w1 = time.time_ns()
            prof.stop()
        self.summary = summarize(prof, (h0 + h1) // 2, (w0, w1),
                                 self.intervals)


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA],
        record_shapes=False, with_stack=False, profile_memory=False)


def _ns(e, which: str) -> int:
    f = getattr(e, f"{which}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{which}_us")() * 1000)


def summarize(prof, marker_host_ns: int, window_host: tuple[int, int],
              spans_host: list[tuple[int, int, str]]) -> dict:
    """Busy and window seconds, kernel seconds by name, and idle seconds
    by the span open at each gap, from the profiler's raw events. The
    marker is the fill kernel that starts nearest ``marker_host_ns`` (its
    launch), within ``MARKER_SLACK_NS``; host times move onto the trace's
    clock by its offset (0 where no fill is that near)."""
    cuda = torch.autograd.DeviceType.CUDA
    device = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or e.is_user_annotation():
            continue
        start = _ns(e, "start")
        device.append((start, start + _ns(e, "duration"), e.name()))
    if not device:
        raise RuntimeError("the traced window recorded no device activity")
    device.sort()
    fills = [d for d in device if MARKER_KERNEL in d[2]
             and abs(d[0] - marker_host_ns) <= MARKER_SLACK_NS]
    marker = min(fills, key=lambda d: abs(d[0] - marker_host_ns),
                 default=None)
    offset = 0 if marker is None else marker[0] - marker_host_ns
    w0, w1 = (t + offset for t in window_host)
    by_kernel: dict[str, float] = collections.defaultdict(float)
    intervals = []
    for s, e, name in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        by_kernel[name] += (e - s) / 1e9
        intervals.append((s, e))
    busy, gaps, cur_s, cur_e = 0, [], None, w0
    for s, e in intervals:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            if s > cur_e:
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    if w1 > cur_e:
        gaps.append((cur_e, w1))
    inner = sorted((s + offset, e + offset, n) for s, e, n in spans_host)
    starts = [s[0] for s in inner]
    idle: dict[str, float] = collections.defaultdict(float)
    for g0, g1 in gaps:
        idle[_owner(inner, starts, (g0 + g1) // 2)] += (g1 - g0) / 1e9
    return {"busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9,
            "kernels_s": dict(by_kernel), "idle_by_span_s": dict(idle),
            "device_events": len(intervals), "clock_offset_ns": offset,
            "marker_found": marker is not None}


def _owner(spans_sorted, starts, t) -> str:
    """The innermost span open at time ``t`` (the latest started of those
    that contain it; spans of the harness nest at most a few deep), else
    the window."""
    i = bisect.bisect_right(starts, t)
    for s, e, name in reversed(spans_sorted[max(0, i - 64):i]):
        if e >= t:
            return name
    return WINDOW
