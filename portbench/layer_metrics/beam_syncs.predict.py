"""The blocking host-device synchronisations inside the program's
``generate.step`` span, mean a decode position over the traced window."""

from portbench.program_spans import syncs


def read(run):
    return syncs(run, "generate.step")
