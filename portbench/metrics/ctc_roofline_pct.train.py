"""The alignment's share of its roofline: the bound of the window's CTC DP
work over the device time of the kernels given to the CTC layer."""

from portbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "ctc")
