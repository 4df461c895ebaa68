"""Set-up: from the process's start to the first timed step or frame,
with the kernel builds, the world's start and the warm-up (host clock)."""


def read(record):
    return record["setup_s"]
