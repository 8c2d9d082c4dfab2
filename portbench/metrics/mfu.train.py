"""The training window's matrix flop over its time, a share of the card's
peak for the configuration's precision."""

from portbench.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx, train=True)
