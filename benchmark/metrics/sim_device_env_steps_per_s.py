"""Env-steps per second of device-busy time, over the profiled slice that
follows the window: the envs of a step times the slice's steps, over the union
of the device's operation intervals in it. The rate the card gives where the
host keeps it fed."""


def read(record):
    if record.slice is None:
        return None
    return record.traffic["num_envs"] * record.slice.steps / record.slice.busy_s
