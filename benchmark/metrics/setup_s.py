"""Seconds from the process's start to the first timed step."""


def read(run):
    return run.setup_s if run.trace is None else None
