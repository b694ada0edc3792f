"""The reflector's fold of the watch events into its stores, its index and the delta engine's buffer (span sync/fold), per 1,000 pods bound, ms."""

from benchmark.critical_path import nested_spans, per_kpod


def read(trace):
    return per_kpod(trace, nested_spans("sync/fold"))
