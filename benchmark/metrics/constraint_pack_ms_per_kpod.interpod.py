"""The host's packing of the inter-pod constraint tensors (span pack/constraints), per 1,000 pods bound, ms; None on a program without the span (its cycle records lack constraint_widths, the field that came with it)."""

from benchmark.critical_path import nested_spans, per_kpod


def read(trace):
    if any("constraint_widths" not in c for c in trace["cycles"]):
        return None
    return per_kpod(trace, nested_spans("pack/constraints"))
