"""Kernel 6's share of its roofline (%): the least time of each launch
in the window (``benchmark/kernels/k6.py``), summed, over the launches'
device time; nothing where kernel 6 did not run."""


def read(ctx):
    return ctx.roofline("k6")
