"""The attention kernels' (K2-K5) share of their roofline in the traced
window: each launch's bound (`roofline`) summed, over their summed device
time."""

from portbench.readers import attn_roofline


def read(run):
    return attn_roofline(run, "train")
