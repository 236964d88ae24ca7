"""Host ms a ``step`` call inside the program's ``usv.gym.to_host`` spans over
the profiled slice: the copies to pinned host memory and the one wait for
the card. Read as ``env_dynamics_host_ms`` reads its span."""

from benchmark.metrics.env_dynamics_host_ms import span_ms


def read(record):
    return span_ms(record, "usv.gym.to_host")
