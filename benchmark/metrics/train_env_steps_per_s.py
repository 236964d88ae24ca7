"""Env-steps collected in the window's rounds over the window's seconds
(whole rounds, updates included; the window opens after a synchronize and
closes with one after the round that crosses its end)."""


def read(record):
    return record.window["env_steps"] / record.window["seconds"]
