"""``spp_per_s``: frames completed in the window times the samples a
pixel each guarantees, over the window's seconds."""


def read(ctx):
    return ctx["frames"] * ctx["cfg"].spp / ctx["window_s"]
