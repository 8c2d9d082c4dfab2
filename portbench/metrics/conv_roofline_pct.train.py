"""The image layers' share of their roofline: the bound of the traced
steps' convolution, tanh and pool work (the family's "conv") over the
device time of the kernels launched under the program's spans
clstm.conv.fwd and clstm.conv.bwd."""

from portbench.readers import span_roofline_pct

SPANS = ("clstm.conv.fwd", "clstm.conv.bwd")


def read(ctx):
    return span_roofline_pct(ctx, SPANS, "conv")
