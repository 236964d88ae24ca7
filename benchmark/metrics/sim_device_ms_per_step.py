"""Device-busy ms per step over the slice: the union of the device's
operation intervals, divided by the steps."""


def read(record):
    if record.slice is None:
        return None
    return record.slice.busy_s / record.slice.steps * 1e3
