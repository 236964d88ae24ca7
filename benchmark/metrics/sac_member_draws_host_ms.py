"""Host ms a round inside the program's ``usv.sac.member_draws`` spans over
the profiled slice: the seed population's host loops over its members'
generators (each collect step's gSDE normals, warm-up actions and reset
blocks, and each update's replay indices and noise), a loop that grows with
the member count. Read as ``env_dynamics_host_ms`` reads its span; nothing
from a program whose population round opens no span (``usv.sac.collect``)."""

from benchmark.metrics.env_dynamics_host_ms import span_ms

SPAN = "usv.sac.member_draws"


def read(record):
    if record.slice is None:
        return None
    from usv_tpu_torch import timing

    if "usv.sac.collect" not in getattr(timing, "span_totals", dict)():
        return None
    return span_ms(record, SPAN)
