"""The delta engine's SolveState rebuild after each full wave (span delta/commit/rebuild), per 1,000 pods bound, ms."""

from benchmark.critical_path import nested_spans, per_kpod


def read(trace):
    return per_kpod(trace, nested_spans("delta/commit/rebuild"))
