"""Host ms a step inside the program's ``usv.env.reset`` spans over the
profiled slice: the fresh resets' draw, transform and observation (every row
of every step on the full-width path; on the CA family the transform holds a
whole bootstrap step). Read as ``env_dynamics_host_ms`` reads its span."""

from benchmark.metrics.env_dynamics_host_ms import span_ms


def read(record):
    return span_ms(record, "usv.env.reset")
