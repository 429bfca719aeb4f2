"""Mean host ms of a served call before its synchronize (the program's
enqueue), over the window's requests."""


def read(run):
    enq = run.get("enqueue")
    return 1e3 * sum(enq) / len(enq) if enq else None
