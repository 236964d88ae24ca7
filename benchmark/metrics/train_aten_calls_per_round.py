"""aten calls the profiler sees inside the slice's rounds, per round: the
host dispatch of 64 collect steps, the replay insert and 16 updates."""


def read(record):
    if record.slice is None:
        return None
    return record.slice.aten_calls / record.slice.steps
