"""The column LSTM's share of its roofline: the bound of the traced steps'
column-LSTM work (the family's "ysum": one direction's forward, chain and
contractions over every pooled column) over the device time of the kernels
launched under the program's spans clstm.ysum.fwd and clstm.ysum.bwd."""

from portbench.readers import span_roofline_pct

SPANS = ("clstm.ysum.fwd", "clstm.ysum.bwd")


def read(ctx):
    return span_roofline_pct(ctx, SPANS, "ysum")
