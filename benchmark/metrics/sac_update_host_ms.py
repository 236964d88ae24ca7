"""Host ms a round inside the program's ``usv.sac.update`` spans over the
profiled slice: the round's fused updates. Read as ``env_dynamics_host_ms``
reads its span."""

from benchmark.metrics.env_dynamics_host_ms import span_ms


def read(record):
    return span_ms(record, "usv.sac.update")
