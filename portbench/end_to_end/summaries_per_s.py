"""Summaries finished over the time their whole batches took."""


def read(run):
    if run.workload["entry"] != "predict" or "window_items" not in run.facts:
        return None
    return run.facts["window_items"] / run.facts["window_s"]
