"""``generate``'s wall time over its beam steps: the sum of the traced
batches' ``generate`` spans (synchronised) over their steps, ms a step."""


def read(run):
    gen, steps = run.facts.get("generate_s"), run.facts.get("decode_steps")
    return 1000 * sum(gen) / steps if gen and steps else None
