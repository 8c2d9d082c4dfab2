"""The affine layer's share of its roofline: the bound of the traced steps'
affine work (the softmax's forward, dx and dW, and the hoisted input
product's forward where a layer hoists) over the device time of the kernels
launched under the program's spans clstm.affine.fwd, clstm.affine.bwd and
clstm.hoist."""

from portbench.readers import span_roofline_pct

SPANS = ("clstm.affine.fwd", "clstm.affine.bwd", "clstm.hoist")


def read(ctx):
    return span_roofline_pct(ctx, SPANS, "affine")
