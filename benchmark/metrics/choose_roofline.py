"""Kernel #1's share of its roofline over the cycles that launched only #1, %."""

from benchmark.readers import roofline_share


def read(trace):
    return roofline_share(trace)
