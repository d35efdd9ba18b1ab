"""The traced window: torch.profiler over a few of the window's work items.

A session records host operations and the card's operations (kernels,
copies, fills). From it: each device operation's interval, their union
(the busy seconds), the top operations by device time, and the longest
gaps between device operations, each named by the innermost host event
that spans it (the benchmark's own `gpbench.*` ranges name the calls into
the program). A session that recorded no device operation at all is run
again over the next items, three sessions in all: now and then a session
on the card loses every kernel record.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

__all__ = ["Tracer", "Trace", "union_s", "top_ops", "idle_gaps"]


@dataclass
class Trace:
    window_s: float  # host seconds from the session's start to its end, both synchronized
    prof: object  # the profiler session, read by `read()` once the window has closed
    launches: dict  # the program's launch counters over the session
    items: list  # what the loop noted of each traced work item
    ops: list = field(default_factory=list)  # device operations (name, start_us, end_us)
    host: list = field(default_factory=list)  # host events (name, start_us, end_us)
    busy_s: float = 0.0

    def read(self) -> None:
        """Takes the session's events apart; the session itself goes."""
        self.ops, self.host = _events(self.prof)
        self.prof = None
        self.busy_s = union_s(self.ops)

    def kernels(self) -> list:
        return [op for op in self.ops if not op[0].startswith(("Memcpy", "Memset"))]


def union_s(ops) -> float:
    """Seconds covered by the union of the intervals."""
    total, end = 0.0, None
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total * 1e-6


def top_ops(ops, k: int = 10) -> list:
    """[[name, seconds]] of the k device operations with the most time."""
    by = {}
    for name, s, e in ops:
        by[name] = by.get(name, 0.0) + (e - s) * 1e-6
    return [[n[:160], t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(ops, host, k: int = 10) -> list:
    """[[what the host was doing, seconds]] of the k longest gaps between
    device operations."""
    gaps, end = [], None
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    out = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
        mid = 0.5 * (g0 + g1)
        spans = [(e - s, name) for name, s, e in host if s <= mid <= e]
        out.append([min(spans)[1][:160] if spans else "host, no event", (g1 - g0) * 1e-6])
    return out


def _events(prof):
    """(device operations, host events); a range's mirror on the device's
    timeline (`record_function` puts one there) is neither."""
    from torch.autograd import DeviceType

    ops, host = [], []
    for e in prof.events():
        row = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CPU:
            host.append(row)
        elif not (getattr(e, "is_user_annotation", False) or e.name.startswith("gpbench.")):
            ops.append(row)
    return ops, host


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


class Tracer:
    """Traces `items` consecutive work items of a window, when enabled.
    The loop calls `begin()` before each item and, if it said the item is
    traced, `end(info)` after it, with what it knows of the item."""

    def __init__(self, enabled: bool, items: int, counters, sessions: int = 3):
        self.items, self.counters = items, counters
        self.sessions = sessions if enabled else 0
        self.prof = None
        self.trace: Trace | None = None
        self.overhead_s = 0.0  # seconds spent closing sessions, which the window leaves out
        if enabled:  # the profiler's first session starts its tracing library: seconds
            with _profiler():
                torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu")

    @property
    def open(self) -> bool:
        """Whether a session is running: the loop's window does not end in one."""
        return self.prof is not None

    def elapsed(self, t0: float) -> float:
        """Seconds since t0, less those spent closing sessions (the profiler
        takes its records apart then: seconds for a few hundred thousand
        kernels)."""
        return time.perf_counter() - t0 - self.overhead_s

    def begin(self) -> bool:
        """Whether the next item is traced."""
        if self.trace is not None or self.sessions == 0:
            return False
        if self.prof is None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.notes, self.before = [], self.counters()
            self.prof = _profiler()
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        return True

    def end(self, info: dict) -> None:
        self.notes.append(info)
        if len(self.notes) >= self.items:
            self.close()

    def close(self) -> None:
        """Ends an open session (the loop calls it when its window ends);
        keeps it if it recorded a device operation, or if there is no card."""
        if self.prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        window = t1 - self.t0
        self.prof.__exit__(None, None, None)
        after = self.counters()
        prof, self.prof, self.sessions = self.prof, None, self.sessions - 1
        from torch.autograd import DeviceType

        if not torch.cuda.is_available() or any(
                e.device_type != DeviceType.CPU for e in prof.events()):
            launches = {k: after[k] - self.before.get(k, 0) for k in after}
            self.trace = Trace(window, prof, launches, self.notes)
        self.overhead_s += time.perf_counter() - t1
