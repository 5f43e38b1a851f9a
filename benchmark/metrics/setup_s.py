"""``setup_s``: seconds from the process's start to the window's start:
imports, the card's context, building the program's library on a first
run, the scene and its tables, the warm-up."""


def read(ctx):
    return ctx["setup_s"]
