"""Device ms per step under the program's ``vtt:optim`` span
(``train/optim.py``: the optimizer's update and ``zero_grad``). The twin of
``optim_ms.train``, read from inside the program."""


def read(run):
    tr = run.get("trace")
    if tr is None or "steps" not in run:
        return None
    spent = tr.seconds(lambda ctx: "vtt:optim" in ctx)
    return 1e3 * spent / tr.units if spent else None
