"""The card's peak of allocated memory over set-up and window, in GiB."""


def read(run):
    return run.facts["peak_bytes"] / 2**30
