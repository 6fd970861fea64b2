"""Image-caption pairs of every step the window ran, over the window's
wall time (the window ends in a synchronise)."""


def read(ctx):
    return ctx["pairs"] / ctx["window_s"]
