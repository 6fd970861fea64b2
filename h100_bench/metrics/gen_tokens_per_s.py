"""Tokens generated in the window over its wall time: every served token
of the static batches that ran (a batch is whole: the window is a whole
number of batches)."""


def read(ctx):
    return ctx["tokens"] / ctx["window_s"]
