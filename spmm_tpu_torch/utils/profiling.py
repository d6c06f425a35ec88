"""Device profiling — per-kernel time breakdown of a computation (port of
``spmm_tpu/utils/profiling.py``), and the program's spans.

``profile_fn`` runs a function under ``torch.profiler`` and aggregates the
card's time per kernel (and copy) name; ``source`` is the PyTorch op that
launched the kernel (``aten::index_select``, ...), read from the profiler's
own op-to-kernel links.  The hand-written kernels launch through ctypes,
outside any op, so their source is empty and their name is the kernel's
(``ell_slabs_kernel<...>``).  Without a CUDA device there is no device time:
the op list is empty and the total is NaN, as the JAX package's is off the
TPU.

``span(name)`` marks a layer of the program (the ``spmm.*`` names, listed in
the README's "Tracing"): a ``torch.profiler.record_function`` while a
profiler runs, so the span lands on the profiler's clock beside the kernels
and copies it encloses, and a shared no-op otherwise.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Callable

import torch
from torch.autograd import profiler as _autograd_profiler

#: prefix of the program's span names
SPAN_PREFIX = "spmm."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` as a host event of the running
    ``torch.profiler`` session, or the shared no-op when none runs.  The
    profiler's own flag is read at each entry (a session may start at any
    point of a process); it is set by ``torch.profiler.profile.start()`` and
    seen on every thread, autograd's backward thread too."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


@dataclasses.dataclass
class OpTime:
    name: str  #: kernel (or copy) name
    ms: float  #: device time per run
    source: str  #: the op that launched it, "" when none did
    count: float = 0.0  #: launches per run

    def __str__(self) -> str:
        return f"{self.ms:9.3f} ms  x{self.count:<6g} {self.name[:70]:<70} {self.source}"


@dataclasses.dataclass
class Profile:
    total_device_ms: float  #: the card's busy time per run
    ops: list  #: list[OpTime], descending by time
    #: host ms per run of each ``spmm.*`` span, descending (on the CPU too)
    spans: dict = dataclasses.field(default_factory=dict)

    def top(self, n: int = 15) -> str:
        lines = [f"device total: {self.total_device_ms:.3f} ms"]
        lines += [str(o) for o in self.ops[:n]]
        lines += [f"{ms:9.3f} ms  host  {name}" for name, ms in self.spans.items()]
        return "\n".join(lines)

    def by_source(self) -> dict:
        agg = collections.defaultdict(float)
        for o in self.ops:
            agg[o.source or "?"] += o.ms
        return dict(sorted(agg.items(), key=lambda kv: -kv[1]))


def _fence(out, fence) -> None:
    if fence is not None:
        fence(out)
    elif torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def profile_fn(fn: Callable, *args, fence: Callable | None = None, repeats: int = 1,
               warm: bool = True, **kwargs) -> Profile:
    """Run ``fn(*args, **kwargs)`` ``repeats`` times under a profiler trace
    (after one run outside it, unless ``warm=False``) and aggregate the
    device time per kernel and the host time per ``spmm.*`` span, per run.
    ``fence`` (default: ``torch.cuda.synchronize()``) forces completion
    inside the trace window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        _fence(fn(*args, **kwargs), fence)
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        for _ in range(repeats):
            out = fn(*args, **kwargs)
        _fence(out, fence)
    averages = prof.key_averages()
    spans = sorted(((e.key, e.cpu_time_total / repeats / 1e3) for e in averages
                    if e.device_type == DeviceType.CPU and e.key.startswith(SPAN_PREFIX)), key=lambda kv: -kv[1])
    if not cuda:
        return Profile(total_device_ms=float("nan"), ops=[], spans=dict(spans))
    source = {}
    for e in prof.events():
        for kern in getattr(e, "kernels", None) or ():
            source.setdefault(kern.name, e.name)
    # a span's device-side copy (the interval of the work it enclosed) is no kernel
    ops = [
        OpTime(name=e.key, ms=e.self_device_time_total / repeats / 1e3, source=source.get(e.key, ""),
               count=e.count / repeats)
        for e in averages
        if e.device_type != DeviceType.CPU and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False)
    ]
    ops.sort(key=lambda o: -o.ms)
    return Profile(total_device_ms=sum(o.ms for o in ops), ops=ops, spans=dict(spans))
