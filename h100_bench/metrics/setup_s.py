"""Set-up seconds: from the process's start to the window's (imports,
the card, weights made and quantized, the first steps or warm-up), less
the time that building or loading the program's CUDA libraries took,
which the run reports apart as ``build_s``."""


def read(ctx):
    return ctx["setup_s"]
