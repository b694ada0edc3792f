"""The share of the traced window in which the card ran no operation (torch.profiler), %."""

from benchmark.readers import idle_share


def read(trace):
    return idle_share(trace)
