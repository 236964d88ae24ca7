"""Host ms a step inside the program's ``usv.env.dynamics`` spans over the
profiled slice: the env family's own step (controller and dynamics, ray-cast,
guidance, reward). The program's spans time themselves only while a profiler
records, and a run profiles only its slice, so their totals are the slice's.
Nothing from a program without spans; a slice that ran the program's spans
but not this one is a fault of the spans, and raises."""

SPAN = "usv.env.dynamics"


def span_ms(record, name: str, kind: str = "total_ms"):
    """``kind`` (``total_ms`` or ``self_ms``) of the span ``name`` over the
    slice, per step (per round in a training cell)."""
    if record.slice is None:
        return None
    from usv_tpu_torch import timing

    if not hasattr(timing, "span_totals"):  # a program from before its spans
        return None
    totals = timing.span_totals()
    if not totals:
        # no span ran under a profiler: the slice was not profiled through the program
        return 0.0
    if name not in totals:
        raise RuntimeError(f"the profiled slice ran the program's spans {sorted(totals)} "
                           f"but never {name!r}")
    return totals[name][kind] / record.slice.steps


def read(record):
    return span_ms(record, SPAN)
