"""Images of every train step completed in the window, over the window
(host clock; the window ends with a synchronize)."""


def read(run):
    return run["images"] / run["window_s"] if "steps" in run else None
