"""The 95th percentile (nearest rank) of every ``step`` call's host-clock
latency in the window, in ms."""

from benchmark.harness import percentile


def read(record):
    return percentile(record.window["latencies_s"], 95) * 1e3
