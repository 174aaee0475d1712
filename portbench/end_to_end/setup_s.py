"""Seconds from the process's start to the start of the window."""


def read(run):
    return run.facts["setup_s"]
