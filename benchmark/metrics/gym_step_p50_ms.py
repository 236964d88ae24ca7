"""The median (nearest rank) of every ``step`` call's host-clock latency in
the window, in ms: the steadier statistic beside the tail."""

from benchmark.harness import percentile


def read(record):
    return percentile(record.window["latencies_s"], 50) * 1e3
