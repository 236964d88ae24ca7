"""Host ms a step inside the program's ``usv.env.select`` spans over the
profiled slice: the fresh rows put in place of the finished ones (the
leafwise ``where`` and the observation's). Read as ``env_dynamics_host_ms``
reads its span."""

from benchmark.metrics.env_dynamics_host_ms import span_ms


def read(record):
    return span_ms(record, "usv.env.select")
