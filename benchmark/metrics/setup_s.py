"""Seconds from the process's start to the first timed step: imports, the
CUDA context, the kernel library's build or load, the program's set-up and
the warm-up steps."""


def read(record):
    return record.setup_s
