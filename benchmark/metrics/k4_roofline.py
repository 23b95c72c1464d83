"""Kernel 4's share of its roofline (%): the least time of each launch
in the window (``benchmark/kernels/k4.py``), summed, over the launches'
device time."""


def read(ctx):
    return ctx.roofline("k4")
