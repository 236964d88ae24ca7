"""Device time of a function on the card, by CUDA events."""

from __future__ import annotations

import torch


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
