"""The device stream's time across the program's ``generate.decode`` span
(the cached decoder, the copy head and the mixture), between the CUDA
events at its ends, median over the traced window's steps, ms. What
``decode_step_ms.predict`` holds beyond it is the beam search's own work;
None off CUDA."""

from portbench.program_spans import stream_ms


def read(run):
    return stream_ms(run, "generate.decode")
