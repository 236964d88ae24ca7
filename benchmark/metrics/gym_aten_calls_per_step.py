"""aten calls the profiler sees inside the slice's ``step`` calls, per call:
the adapter's host path, resets left out."""


def read(record):
    if record.slice is None:
        return None
    return record.slice.aten_calls / record.slice.steps
