"""Device time of a function on the card, by CUDA events, and its\nprofile (torch.profiler)."""

from __future__ import annotations

import torch


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


def time_device(fn, calls=20, replays=10):
    """Device ms per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so the host's
    per-call Python cost (more than the kernel's own time for the ray-cast
    wrapper) does not set the pace."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the default stream, as capture requires
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_cuda(graph.replay, replays) / calls


def profiled(fn, calls, device="cuda"):
    """Aten calls, device kernels and device ms per call of ``fn`` over
    ``calls`` calls (torch.profiler). On the CPU only the aten calls are
    counted; the device figures are ``None``. Raises if a CUDA run shows
    the profiler no device activity."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*Profiler clears events.*")
        with profile(activities=activities) as prof:
            for _ in range(calls):
                fn()
            if cuda:
                torch.cuda.synchronize()
    aten = sum(e.count for e in prof.key_averages() if e.key.startswith("aten::")) / calls
    if not cuda:
        return {"device_kernels": None, "aten_calls": aten, "device_ms": None}
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler saw no device activity")
    return {"device_kernels": len(kernels) / calls, "aten_calls": aten,
            "device_ms": sum(e.device_time for e in kernels) / 1e3 / calls}


def step_anatomy(benv, state, wall_ms, steps=20):
    """Kernels and device time of one zero-action auto-reset step of the
    ``BatchedEnv`` ``benv`` from ``state`` (torch.profiler over ``steps``
    steps) beside the unprofiled wall ms per step ``wall_ms``: the figures
    of :func:`profiled` plus ``wall_ms`` and the device's ``idle_share``."""
    actions = torch.zeros((benv.num_envs, benv.cfg.action_dim), device=benv.device)
    box = [state]

    def step():
        box[0], _ = benv.step(box[0], actions)

    a = profiled(step, steps, benv.device)
    idle = None if a["device_ms"] is None else 1 - a["device_ms"] / wall_ms
    a.update(wall_ms=wall_ms, idle_share=idle)
    return a
