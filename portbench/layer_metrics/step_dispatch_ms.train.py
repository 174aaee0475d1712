"""The host time of the program's ``train.step`` span (the forward pass
through the optimizer's update, the loss read left out), median over the
traced window's steps, ms: the time the host takes to enqueue a step, and to
wait where the step synchronises."""

from portbench.program_spans import host_ms


def read(run):
    return host_ms(run, "train.step")
