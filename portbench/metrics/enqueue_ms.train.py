"""Host ms to enqueue one training step on an idle card: a block call's
host time after a synchronize, over its K steps."""


def read(ctx):
    return ctx.get("enqueue_ms")
