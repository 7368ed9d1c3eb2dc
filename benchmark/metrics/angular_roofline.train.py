"""K3, K3b and K3bb's share of their roofline in the force-training step."""

from benchmark import readers


def read(ctx):
    return readers.angular_roofline(ctx, second_order=True)
