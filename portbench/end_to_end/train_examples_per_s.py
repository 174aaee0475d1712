"""Training examples completed over the window's whole time."""


def read(run):
    if "window_items" not in run.facts or run.workload["entry"] == "predict":
        return None
    return run.facts["window_items"] / run.facts["window_s"]
