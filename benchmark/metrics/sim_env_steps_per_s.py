"""Env-steps completed in the window over the window's seconds (the window
opens after a synchronize and closes with one)."""


def read(record):
    return record.window["env_steps"] / record.window["seconds"]
