"""The share of the profiled window in which no kernel ran on the card."""

from portbench.readers import idle_pct


def read(run):
    return idle_pct(run, "train")
