"""Kernel 3's share of its roofline (%): the least time of each launch
in the window (``benchmark/kernels/k3.py``), summed, over the launches'
device time."""


def read(ctx):
    return ctx.roofline("k3")
