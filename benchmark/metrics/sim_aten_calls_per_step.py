"""aten calls the profiler sees inside the slice's steps, per step: the host
dispatch of the env step, the auto-reset and the select."""


def read(record):
    if record.slice is None:
        return None
    return record.slice.aten_calls / record.slice.steps
