"""Set-up: process start to the window's start (import, card, kernels
loaded or built, weights and data made from the seed, warm-up), host clock."""


def read(run):
    return run["setup_s"]
