"""Host ms a step inside the program's ``usv.env.substeps`` spans over the
profiled slice: the {controller -> Fossen dynamics} substep loops, those of
the step and those of the fresh resets' bootstrap step. Read as
``env_dynamics_host_ms`` reads its span."""

from benchmark.metrics.env_dynamics_host_ms import span_ms


def read(record):
    return span_ms(record, "usv.env.substeps")
