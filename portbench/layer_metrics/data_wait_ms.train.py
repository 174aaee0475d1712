"""Host time a training step waits for its batch (the port's native
loader and ``cli.device_batch``), mean over the traced window's steps, ms."""


def read(run):
    waits = run.facts.get("data_wait_s")
    return 1000 * sum(waits) / len(waits) if waits else None
