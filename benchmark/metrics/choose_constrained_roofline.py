"""Kernel #2's share of its roofline over the cycles that launched only #2, with the bitmap widths each cycle record carries (constraint_widths), %."""

from benchmark.readers import roofline_share


def read(trace):
    return roofline_share(trace, "2")
