"""1 − device busy time per profiled step (union over streams) / the
unprofiled window's time per step, in %."""


def read(run):
    tr = run.get("trace")
    if tr is None or "steps" not in run or not run["steps"]:
        return None
    return 100.0 * (1.0 - (tr.busy_s / tr.units) / (run["window_s"] / run["steps"]))
