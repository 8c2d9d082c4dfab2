"""The LSTM layer's share of its roofline: the bound of the window's LSTM
work over the device time of the kernels given to the LSTM layer."""

from portbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "lstm")
