"""The MD step's share of the f32 peak: networks forward and input backward, AEV to first derivatives; D3 and repulsion not counted."""

from benchmark import readers


def read(ctx):
    return readers.mfu(ctx, products=2, aev_order=1, members=ctx.config["members"])
