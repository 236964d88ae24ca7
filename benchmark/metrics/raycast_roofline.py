"""The ray-cast kernel's share of its roofline, in %: the least time of one
launch (``benchmark/roofline.py``, from its shapes and the live inputs) over
the mean device time of its launches in the slice, found by the kernel's
name. Nothing when the slice launched it not at all."""

KERNEL = "raycast_kernel"


def read(record):
    if record.slice is None or "raycast" not in record.slice.extra:
        return None
    times = record.slice.kernel_durations(KERNEL)
    if not times:
        return None
    return record.slice.extra["raycast"]["seconds"] / (sum(times) / len(times)) * 100.0
