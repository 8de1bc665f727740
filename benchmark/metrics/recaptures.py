"""recaptures: frames the program captured anew during the window
(Renderer.stats["captures"] over the window): each costs a warm frame and
a capture inside a frame's time."""


def read(ctx):
    return ctx.stats.get("captures")
