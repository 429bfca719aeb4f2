"""Images of every request completed in the window, over the window (host
clock)."""


def read(run):
    return run["images"] / run["window_s"] if "requests" in run else None
