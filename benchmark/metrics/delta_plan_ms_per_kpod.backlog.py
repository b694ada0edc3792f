"""The delta engine's plan: the watch-event fold into the SolveState, the invalidation closure and the repack (spans delta/index, delta/close, delta/repack), per 1,000 pods bound, ms."""

from benchmark.critical_path import nested_spans, per_kpod


def read(trace):
    return per_kpod(trace, nested_spans("delta/index", "delta/close", "delta/repack"))
