"""The train step's optimizer phase (the program's own ``phase_times``,
which synchronise each phase), median over the phased half of the traced
window, ms."""

from portbench.readers import phase_ms


def read(run):
    return phase_ms(run, "optimizer")
