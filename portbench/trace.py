"""The traced window: ``torch.profiler`` over the whole window, read from the
profiler's raw events (no per-event Python objects are built for the tree).

Device activity is every kernel, copy and memset on the card; the window is
the harness's own ``portbench.window`` span.  An idle gap of the device is
named by what the host was doing at its middle: the innermost host event
(an operator, a CUDA runtime call or a harness span) that covers that time
on any thread, or ``(no host event)``."""

from __future__ import annotations

import collections
import dataclasses

import numpy as np

WINDOW_SPAN = "portbench.window"
CALL_SPAN = "portbench.call"
NO_HOST = "(no host event)"


@dataclasses.dataclass
class Trace:
    """Times in nanoseconds on the profiler's clock, clipped to the window."""

    t0: int
    t1: int
    calls: int  #: calls completed in the window
    dev_start: np.ndarray
    dev_end: np.ndarray
    dev_kind: list  #: "kernel", "gpu_memcpy" or "gpu_memset" per device event
    dev_name: list
    host_start: np.ndarray
    host_end: np.ndarray
    host_thread: np.ndarray
    host_name: list

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def seconds(self, select) -> float:
        """Summed device time of the events for which ``select(kind, name)``."""
        dur = self.dev_end - self.dev_start
        return float(sum(d for d, k, n in zip(dur, self.dev_kind, self.dev_name) if select(k, n))) * 1e-9

    def busy_intervals(self):
        """The union of the device's events, as (start, end) arrays."""
        if len(self.dev_start) == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        order = np.argsort(self.dev_start, kind="stable")
        s, e = self.dev_start[order], np.maximum.accumulate(self.dev_end[order])
        new = np.ones(len(s), bool)
        new[1:] = s[1:] > e[:-1]
        starts = s[new]
        last = np.r_[np.flatnonzero(new)[1:] - 1, len(s) - 1]
        return starts, e[last]

    def busy_s(self) -> float:
        s, e = self.busy_intervals()
        return float((e - s).sum()) * 1e-9

    def idle_gaps(self):
        """(start, end) arrays of the window's stretches with no device event."""
        s, e = self.busy_intervals()
        g0 = np.r_[self.t0, e]
        g1 = np.r_[s, self.t1]
        keep = g1 > g0
        return g0[keep], g1[keep]

    def host_at(self, t: np.ndarray) -> list:
        """The name of the innermost host event covering each time in ``t``."""
        best = np.full(len(t), -1, np.int64)
        best_start = np.full(len(t), np.iinfo(np.int64).min)
        for thread in np.unique(self.host_thread):
            idx = np.flatnonzero(self.host_thread == thread)
            idx = idx[np.lexsort((-(self.host_end[idx]), self.host_start[idx]))]
            s, e = self.host_start[idx], self.host_end[idx]
            parent = _parents(s, e)
            cand = np.searchsorted(s, t, side="right") - 1
            for _ in range(64):  # walk out to the first event that covers t
                miss = (cand >= 0) & (e[np.maximum(cand, 0)] < t)
                if not miss.any():
                    break
                cand = np.where(miss, parent[np.maximum(cand, 0)], cand)
            hit = (cand >= 0) & (e[np.maximum(cand, 0)] >= t)
            st = np.where(hit, s[np.maximum(cand, 0)], np.iinfo(np.int64).min)
            better = hit & (st > best_start)
            best = np.where(better, idx[np.maximum(cand, 0)], best)
            best_start = np.where(better, st, best_start)
        return [self.host_name[b] if b >= 0 else NO_HOST for b in best]


def _parents(s: np.ndarray, e: np.ndarray) -> np.ndarray:
    """The enclosing event of each of one thread's events, sorted by start
    (outer first at equal starts); -1 at the top."""
    parent = np.full(len(s), -1, np.int64)
    stack: list = []
    ends = e.tolist()
    for i, si in enumerate(s.tolist()):
        while stack and ends[stack[-1]] < si:
            stack.pop()
        if stack:
            parent[i] = stack[-1]
        stack.append(i)
    return parent


def _kind(ev, cuda) -> str | None:
    """"kernel", "gpu_memcpy" or "gpu_memset" for a device event, "host"
    for a host event, None for a device-side copy of a host span."""
    if ev.device_type() != cuda:
        return "host"
    annotation = getattr(ev, "is_user_annotation", None)
    if annotation is not None and annotation():
        return None
    name = ev.name()
    if name.startswith("portbench."):
        return None
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def collect(prof, calls: int) -> Trace:
    """The window's events from a stopped ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    window = None
    dev, host = [], []
    for ev in events:
        kind = _kind(ev, DeviceType.CUDA)
        if kind is None:
            continue
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if kind == "host":
            name = ev.name()
            if name == WINDOW_SPAN:
                window = (start, end)
            host.append((start, end, ev.start_thread_id(), name))
        else:
            dev.append((start, end, kind, ev.name()))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    t0, t1 = window
    clip = lambda rows: [r for r in rows if r[1] > t0 and r[0] < t1]
    dev, host = clip(dev), clip(host)
    arr = lambda rows, i: np.array([min(max(r[i], t0), t1) for r in rows], np.int64)
    return Trace(
        t0=t0, t1=t1, calls=calls,
        dev_start=arr(dev, 0), dev_end=arr(dev, 1), dev_kind=[r[2] for r in dev], dev_name=[r[3] for r in dev],
        host_start=arr(host, 0), host_end=arr(host, 1),
        host_thread=np.array([r[2] for r in host], np.int64), host_name=[r[3] for r in host],
    )


def breakdown(tr: Trace, top: int = 10, width: int = 160) -> dict:
    """The device operations that took most time and the idle time by what
    the host was doing, each as [name, seconds], at most ``top`` of each."""
    ops = collections.Counter()
    for s, e, n in zip(tr.dev_start.tolist(), tr.dev_end.tolist(), tr.dev_name):
        ops[n[:width]] += (e - s) * 1e-9
    g0, g1 = tr.idle_gaps()
    gaps = collections.Counter()
    for name, d in zip(tr.host_at((g0 + g1) // 2), (g1 - g0).tolist()):
        gaps[name[:width]] += d * 1e-9
    return {"device_ops": [[n, s] for n, s in ops.most_common(top)],
            "idle_gaps": [[n, s] for n, s in gaps.most_common(top)]}
