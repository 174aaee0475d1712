"""The host time of the program's ``generate.step`` span (one decode
position: the cached decoder step, then the beam search's own work),
median over the traced window's steps, ms."""

from portbench.program_spans import host_ms


def read(run):
    return host_ms(run, "generate.step")
