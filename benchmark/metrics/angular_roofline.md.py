"""K3 and K3b's share of their roofline in the MD step."""

from benchmark import readers


def read(ctx):
    return readers.angular_roofline(ctx, second_order=False)
