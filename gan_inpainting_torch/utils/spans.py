"""Spans: named stretches of the program's work, and its blocking copies
between the host and a device.

``section(name)`` marks a stretch of work: the train step's phases
(train/step.py), the batch build (data/pipeline.py, data/masks.py), the
parts of a serve call (infer/inpaint.py) and the attention backward. It
does nothing unless a measuring tool installs a hook with
:func:`set_section_hook`, a function ``name -> context manager``; with no
hook it returns one shared null context.

:class:`SpanRecorder` is that hook. For each span it keeps ``(t0, t1,
name, parent, thread)`` on ``time.time_ns``, the wall clock a profiler's
device trace is put on, with ``parent`` the span open around it in the
same thread, so a span's self time is its length less its children's.
With ``events=True`` it also records a CUDA event pair around each span,
for device milliseconds per name. Every thread's spans go to one list:
``Inpainter``'s replicas and group members run on worker threads, and the
autograd engine runs a CUDA backward (``attention_backward``) on a thread
of its own.

:func:`transfer` is the program's one way to copy between the host and a
device on its hot paths: ``t.to(device)``, blocking as ever (a pageable
copy waits for every launch before it), counted in
``parallel.sharding.counts`` (``host_syncs``, ``host_sync_bytes``) and
marked by a ``sync.h2d`` or ``sync.d2h`` span.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import NamedTuple

import torch

from gan_inpainting_torch.parallel.sharding import _count, counts

SYNC = "sync."                    # the prefix of the transfers' spans

_NULL = contextlib.nullcontext()
_section_hook = None


def set_section_hook(hook) -> None:
    """Install (or with None remove) the hook behind :func:`section`."""
    global _section_hook
    _section_hook = hook


def section(name: str):
    hook = _section_hook
    return _NULL if hook is None else hook(name)


def transfer(t: torch.Tensor, device) -> torch.Tensor:
    """``t.to(device)``; where it crosses between the host and a device,
    counted and spanned as a blocking transfer."""
    device = torch.device(device)
    to_host = device.type == "cpu"
    if (t.device.type == "cpu") == to_host:
        return t.to(device)
    with section(SYNC + ("d2h" if to_host else "h2d")):
        out = t.to(device)
    _count("host_syncs")
    _count("host_sync_bytes", t.numel() * t.element_size())
    return out


class Span(NamedTuple):
    t0: int                       # time.time_ns at the start
    t1: int
    name: str
    parent: str | None            # the span open around it in its thread
    thread: str
    sync_ns: int                  # of which in sync.* spans inside it


class SpanRecorder:
    """Records every :func:`section` while installed as its hook. Safe to
    use from several threads at once."""

    def __init__(self, events: bool = False):
        self.events = events
        self.spans: list[Span] = []
        self._pairs: list[tuple[str, torch.cuda.Event, torch.cuda.Event]] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._counts0 = dict(counts)

    def _event(self):
        if not self.events:
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    @contextlib.contextmanager
    def __call__(self, name: str):
        stack = self._local.__dict__.setdefault("stack", [])
        parent = stack[-1][0] if stack else None
        frame = [name, 0]
        stack.append(frame)
        start = self._event()
        t0 = time.time_ns()
        try:
            yield
        finally:
            t1 = time.time_ns()
            end = self._event()
            stack.pop()
            if name.startswith(SYNC):
                for outer in stack:
                    outer[1] += t1 - t0
            span = Span(t0, t1, name, parent,
                        threading.current_thread().name, frame[1])
            with self._lock:
                self.spans.append(span)
                if start is not None:
                    self._pairs.append((name, start, end))

    def intervals(self) -> list[tuple[int, int, str]]:
        """``(t0, t1, name)`` of every span, as a trace's spans are; a
        ``sync.*`` span is named after the span it sits in
        (``batch.rasterize:sync.h2d``), so that what it charges stays
        with that phase."""
        with self._lock:
            return [(s.t0, s.t1, f"{s.parent}:{s.name}"
                     if s.parent and s.name.startswith(SYNC) else s.name)
                    for s in self.spans]

    def summary(self) -> dict:
        """Per span name its count, host seconds, and host seconds net of
        the ``sync.*`` spans inside it; and how ``sharding.counts`` moved
        since the recorder was made."""
        with self._lock:
            spans = list(self.spans)
        by_name: dict[str, dict] = {}
        for s in spans:
            d = by_name.setdefault(s.name, {"count": 0, "host_s": 0.0,
                                            "net_of_sync_s": 0.0})
            d["count"] += 1
            d["host_s"] += (s.t1 - s.t0) / 1e9
            d["net_of_sync_s"] += (s.t1 - s.t0 - s.sync_ns) / 1e9
        moved = {k: v - self._counts0.get(k, 0) for k, v in counts.items()
                 if v != self._counts0.get(k, 0)}
        return {"spans": by_name, "counts": moved}

    def device_ms(self) -> dict[str, float]:
        """Device milliseconds per span name, summed over its event pairs
        (waits for the last of them)."""
        with self._lock:
            pairs = list(self._pairs)
        out: dict[str, float] = collections.defaultdict(float)
        for name, start, end in pairs:
            end.synchronize()
            out[name] += start.elapsed_time(end)
        return dict(out)
