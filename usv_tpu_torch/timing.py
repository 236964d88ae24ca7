"""The port's measurement tools: device time of a function on the card, by
CUDA events; its profile (torch.profiler); the named host spans of the
program's layers; the launch counters of the ray-cast and ASMC substep
kernels; and the counter of ``BatchedEnv`` steps, replayed from a CUDA graph
or run op by op.

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
    which each replay adds to ``launches`` (:func:`graphed`, and the graph
    of ``BatchedEnv``'s step)."""

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
#: the ASMC substep kernel's launches (``ops/asmc_cuda.py::asmc_substeps_cuda``)
substep_counter = LaunchCounter()
#: every kernel's counter, which a capture tallies and a replay adds to
LAUNCH_COUNTERS = (counter, substep_counter)


class EnvStepCounter:
    """``BatchedEnv.step`` calls by how they ran: ``replayed`` from the
    step's CUDA graph, or ``eager``, op by op on the host. Plain integers
    that a caller may reset; each step raises exactly one of them."""

    def __init__(self):
        self.replayed = 0
        self.eager = 0


#: every ``BatchedEnv``'s steps (``vector/batch.py``)
env_step_counter = EnvStepCounter()


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


def capture(fn, calls=1):
    """One call of ``fn`` on a side stream, as capture requires (lazy
    initialisation and caches happen outside the graph), then ``calls``
    calls of it captured in one CUDA graph on that stream -> ``(graph,
    launches, out)``: ``{counter: launches}`` of each of
    ``LAUNCH_COUNTERS``, the kernel launches captured, which a replay makes
    (:func:`add_replay`), and what the last captured call returned, tensors
    of the graph's pool that each replay writes anew. The warm-up call's
    launches count in the counters' ``launches``, as any call's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        fn()
        for c in LAUNCH_COUNTERS:
            c.captured = 0
        graph.capture_begin()
        try:
            for _ in range(calls):
                out = fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    launches = {}
    for c in LAUNCH_COUNTERS:
        launches[c], c.captured = c.captured, 0
    return graph, launches, out


def add_replay(launches) -> None:
    """Count one replay of a graph whose capture tallied ``launches``
    (``{counter: launches}``, :func:`capture`)."""
    for c, n in launches.items():
        c.launches += n


def graphed(fn, calls=1):
    """``calls`` calls of ``fn`` captured in one CUDA graph (:func:`capture`)
    -> ``replay()``, which launches the graph and adds the kernel launches
    captured in it to their counters."""
    graph, per_replay, _ = capture(fn, calls)

    def replay():
        graph.replay()
        add_replay(per_replay)

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


def _span_ms(before, calls) -> dict:
    """Host ms a call inside each span closed since ``before`` (what
    :func:`span_totals` read then), the longest first."""
    ms = {name: (t["total_ms"] - before.get(name, {}).get("total_ms", 0.0)) / calls
          for name, t in span_totals().items()}
    return {k: v for k, v in sorted(ms.items(), key=lambda kv: -kv[1]) if v > 0}


def profiled(fn, calls, device="cuda"):
    """Aten calls, device kernels and device ms per call of ``fn`` over
    ``calls`` calls (torch.profiler), the device's ``idle_share`` of the
    profiled window (between its two synchronizes) and that idle time in ms
    per call by the innermost ``usv.*`` span open on the host in each gap
    (``idle_by_span``, :func:`idle_by_span`: ``usv.env.dynamics``,
    ``usv.env.substeps``, ``usv.env.path``, ``usv.env.reset``, ...), and
    each span's host ms per call (``span_ms``). On the CPU only the aten
    calls and the spans are counted; the device figures are ``None``.
    Raises if a CUDA run shows the profiler no device activity."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    synchronize(device)
    before = span_totals()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*Profiler clears events.*")
        with profile(activities=activities) as prof:
            with record_function(WINDOW_RANGE):
                for _ in range(calls):
                    fn()
                synchronize(device)
    span_ms = _span_ms(before, calls)
    aten = sum(e.count for e in prof.key_averages() if e.key.startswith("aten::")) / calls
    if not cuda:
        return {"device_kernels": None, "aten_calls": aten, "device_ms": None,
                "idle_share": None, "idle_by_span": None, "span_ms": span_ms}
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
            "idle_by_span": {k: v / 1e3 / calls for k, v in sorted(idle.items(), key=lambda kv: -kv[1])},
            "span_ms": span_ms}


def step_anatomy(benv, state, wall_ms, steps=20):
    """Kernels and device time of one zero-action auto-reset step of the
    ``BatchedEnv`` ``benv`` from ``state`` (torch.profiler over ``steps``
    steps, after one unprofiled step that captures the step's CUDA graph on
    the card), the figures of :func:`profiled`, beside the unprofiled wall ms
    per step ``wall_ms``. The ``idle_share`` is the profiled window's."""
    actions = torch.zeros((benv.num_envs, benv.cfg.action_dim), device=benv.device)
    box = [state]

    def step():
        box[0], _ = benv.step(box[0], actions)

    step()
    return dict(profiled(step, steps, benv.device), wall_ms=wall_ms)
