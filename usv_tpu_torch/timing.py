"""The port's measurement tools: device time of a function on the card, by
CUDA events; its profile (torch.profiler); the named host spans of the
program's layers; and the ray-cast kernel's launch counter.

Spans. :func:`span` marks a phase of the program (``usv.env.step``,
``usv.sac.update``, ...). It does nothing but one check while no profiler
records. While one does, each span is a ``record_function`` range in the
profiler's own trace, on the clock of the device's kernels, and its host time
goes into in-memory totals, per name: the count, the total and the self time
(the total less the time of the spans opened inside it). :func:`span_totals`
reads them and :func:`reset_spans` clears them. The spans open and close on
one thread, the one that drives the card.
"""

from __future__ import annotations

import bisect
import contextlib
import time

import torch
from torch.autograd.profiler import record_function

_profiler_enabled = torch.autograd._profiler_enabled
SPAN_PREFIX = "usv."
WINDOW_RANGE = "profiled.window"
_OFF = contextlib.nullcontext()
_totals = {}   # name -> [count, total ns, self ns]
_open = []     # the spans open now, innermost last


class _Span:
    __slots__ = ("name", "range", "start", "children")

    def __init__(self, name):
        self.name = name
        self.range = record_function(name)

    def __enter__(self):
        self.children = 0
        _open.append(self)
        self.start = time.perf_counter_ns()
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self.range.__exit__(*exc)
        finally:
            ns = time.perf_counter_ns() - self.start
            _open.pop()
            if _open:
                _open[-1].children += ns
            entry = _totals.setdefault(self.name, [0, 0, 0])
            entry[0] += 1
            entry[1] += ns
            entry[2] += ns - self.children
        return False


def span(name: str):
    """A context manager that marks the phase ``name`` of the program: a
    ``record_function`` range timed into :func:`span_totals` while a profiler
    records (``torch.profiler``, or ``emit_nvtx``: the check is the one
    ``record_function`` makes), else a shared no-op context."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name)


def span_totals() -> dict:
    """``{name: {"count", "total_ms", "self_ms"}}`` of every span closed since
    the last :func:`reset_spans`, a copy."""
    return {name: {"count": c, "total_ms": total / 1e6, "self_ms": own / 1e6}
            for name, (c, total, own) in _totals.items()}


def reset_spans() -> None:
    """Forget every span closed so far."""
    _totals.clear()


class LaunchCounter:
    """Kernel launches of one launcher: ``launches`` is a plain integer that a
    caller may reset, raised by one where the kernel launches and nowhere
    else. A call made while the current stream captures a CUDA graph launches
    nothing: it raises ``captured``, the tally of the graph being captured,
    which :func:`graphed` adds to ``launches`` at each replay."""

    def __init__(self):
        self.launches = 0
        self.captured = 0

    def launched(self) -> None:
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1


#: the ray-cast kernel's launches (``ops/raycast_cuda.py::raycast_cuda``)
counter = LaunchCounter()


def synchronize(device) -> None:
    """Wait for ``device``'s queued work (a no-op off the card), so that a
    host clock read next measures the work and not its enqueue."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_cuda(fn, iters):
    """ms per call of ``fn`` by CUDA events around ``iters`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graphed(fn, calls=1):
    """``calls`` calls of ``fn`` captured in one CUDA graph, after one call
    off the default stream as capture requires -> ``replay()``, which
    launches the graph and adds the ray-cast launches captured in it to
    ``counter.launches``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    counter.captured = 0
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    per_replay, counter.captured = counter.captured, 0

    def replay():
        graph.replay()
        counter.launches += per_replay

    return replay


def time_device(fn, calls=20, replays=10):
    """Device ms per call of ``fn``: ``calls`` calls captured in one CUDA
    graph (:func:`graphed`), replayed ``replays`` times between CUDA events
    after one warm-up replay, so the host's per-call Python cost (more than
    the kernel's own time for the ray-cast wrapper) does not set the pace."""
    return time_cuda(graphed(fn, calls), replays) / calls


def idle_by_span(busy, spans, lo, hi) -> dict:
    """The stretches of [lo, hi] that no ``busy`` ``(start, end)`` interval
    covers, each put down whole to the innermost of the host ``spans``
    (``(name, start, end)``) open at its middle, the one of those that started
    last, or else to ``"outside"`` -> ``{name: idle time}`` in the unit of the
    times given."""
    out, reach = {}, lo
    ordered = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in ordered]

    def put(a, b):
        mid = (a + b) / 2
        name = "outside"
        i = bisect.bisect_right(starts, mid)
        while i:
            i -= 1
            if ordered[i][2] >= mid:
                name = ordered[i][0]
                break
        out[name] = out.get(name, 0) + (b - a)

    for start, end in sorted(busy):
        if start > reach:
            put(reach, min(start, hi))
        reach = max(reach, end)
        if reach >= hi:
            break
    if reach < hi:
        put(reach, hi)
    return out


def profiled(fn, calls, device="cuda"):
    """Aten calls, device kernels and device ms per call of ``fn`` over
    ``calls`` calls (torch.profiler), the device's ``idle_share`` of the
    profiled window (between its two synchronizes) and that idle time in ms
    per call by the innermost ``usv.*`` span open on the host in each gap
    (``idle_by_span``, :func:`idle_by_span`). On the CPU only the aten calls
    are counted; the device figures are ``None``. Raises if a CUDA run shows
    the profiler no device activity."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    synchronize(device)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*Profiler clears events.*")
        with profile(activities=activities) as prof:
            with record_function(WINDOW_RANGE):
                for _ in range(calls):
                    fn()
                synchronize(device)
    aten = sum(e.count for e in prof.key_averages() if e.key.startswith("aten::")) / calls
    if not cuda:
        return {"device_kernels": None, "aten_calls": aten, "device_ms": None,
                "idle_share": None, "idle_by_span": None}
    events = prof.events()
    # a record_function range's device side (a span's, the optimizer's) is no kernel
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        raise RuntimeError("the profiler saw no device activity")
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    lo, hi = next((e.time_range.start, e.time_range.end) for e in host if e.name == WINDOW_RANGE)
    busy = [(e.time_range.start, e.time_range.end) for e in kernels]
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in host
             if e.name.startswith(SPAN_PREFIX)]
    idle = idle_by_span(busy, spans, lo, hi)
    return {"device_kernels": len(kernels) / calls, "aten_calls": aten,
            "device_ms": sum(e.device_time for e in kernels) / 1e3 / calls,
            "idle_share": sum(idle.values()) / (hi - lo),
            "idle_by_span": {k: v / 1e3 / calls for k, v in sorted(idle.items(), key=lambda kv: -kv[1])}}


def step_anatomy(benv, state, wall_ms, steps=20):
    """Kernels and device time of one zero-action auto-reset step of the
    ``BatchedEnv`` ``benv`` from ``state`` (torch.profiler over ``steps``
    steps), the figures of :func:`profiled`, beside the unprofiled wall ms per
    step ``wall_ms``. The ``idle_share`` is the profiled window's."""
    actions = torch.zeros((benv.num_envs, benv.cfg.action_dim), device=benv.device)
    box = [state]

    def step():
        box[0], _ = benv.step(box[0], actions)

    return dict(profiled(step, steps, benv.device), wall_ms=wall_ms)
