"""The blocking host-device synchronisations inside the program's
``train.step`` span (torch's sync debug warnings, counted by the program's
recorder), mean a step over the traced window."""

from portbench.program_spans import syncs


def read(run):
    return syncs(run, "train.step")
