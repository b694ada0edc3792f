"""The pods the cycles were cut off from (CycleMetrics.spans count solve/cut_off_pods: the auction's round cap or stall, the mop-up's work cap), per 1,000 pods bound; None on a program that does not count them (its cycle records lack constraint_widths, the field that came with the count)."""


def read(trace):
    cycles = trace["cycles"]
    if not cycles or trace["bound"] <= 0 or any("constraint_widths" not in c for c in cycles):
        return None
    return sum(c["spans"].get("solve/cut_off_pods", 0) for c in cycles) * 1e3 / trace["bound"]
