"""The reflector's snapshot build (span sync/snapshot), per 1,000 pods bound, ms."""

from benchmark.critical_path import nested_spans, per_kpod


def read(trace):
    return per_kpod(trace, nested_spans("sync/snapshot"))
