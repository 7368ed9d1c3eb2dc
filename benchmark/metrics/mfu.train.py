"""The force-training step's share of the f32 peak: six passes of the networks' products, AEV to second derivatives."""

from benchmark import readers


def read(ctx):
    return readers.mfu(ctx, products=6, aev_order=2, members=ctx.traffic["members"])
