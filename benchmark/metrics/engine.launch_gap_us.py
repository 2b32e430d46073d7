"""Median idle time on the device before each device operation of the
traced window (0 where one starts as the last ends): the host's pacing
per launch, which the engine's chunk loop sets where the kernels are
short."""

import statistics

UNIT = "us"


def read(ctx):
    gaps = ctx.between_ops
    return statistics.median(gaps) * 1e6 if gaps else None
