"""The model FLOPs of the profiled window's work (`work`) over its
seconds times the peak of the configuration's precision."""

from portbench.readers import mfu_pct


def read(run):
    return mfu_pct(run, "train")
