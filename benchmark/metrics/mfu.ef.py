"""The E+F call's share of the f32 peak: networks forward and input backward, AEV to first derivatives."""

from benchmark import readers


def read(ctx):
    return readers.mfu(ctx, products=2, aev_order=1, members=ctx.config["members"])
