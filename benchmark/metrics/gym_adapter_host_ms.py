"""Host ms a ``step`` call of the program's ``usv.gym.step`` spans' self time
over the profiled slice: the adapter's own work, outside the family's step
and the copy to the host. Read as ``env_dynamics_host_ms`` reads its span."""

from benchmark.metrics.env_dynamics_host_ms import span_ms


def read(record):
    return span_ms(record, "usv.gym.step", "self_ms")
