"""Host ms a round inside the program's ``usv.sac.collect`` span over the
profiled slice: the round's collect steps (policy, gSDE draws, env steps)
and its one replay insert. Read as ``env_dynamics_host_ms`` reads its span."""

from benchmark.metrics.env_dynamics_host_ms import span_ms


def read(record):
    return span_ms(record, "usv.sac.collect")
