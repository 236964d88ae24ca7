"""The share of the slice's wall time (between its two synchronizes) in which
no operation ran on the device, in %: 1 - union of the device's operation
intervals / the slice's length, both from the one trace."""


def read(record):
    if record.slice is None:
        return None
    return (1.0 - record.slice.busy_s / record.slice.window_s) * 100.0
