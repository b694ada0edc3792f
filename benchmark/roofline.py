"""The table of peaks and the choose kernels' least work, frozen here.

``choose_bound_s`` is a copy of ``chip_smoke.choose_bound_ms``'s
arithmetic (operations over the float32 peak against bytes over the HBM
bandwidth, the larger), in seconds.  The work is counted from the inputs:
one pass over every (pending pod, node) pair of a solve, so it reads the
same whatever design computes it.
"""

from __future__ import annotations

__all__ = ["PEAK_BYTES", "PEAK_F32_OPS", "RESOURCES", "choose_bound_s"]

# Published peaks of one NVIDIA H100 SXM at its full 700 W (NVIDIA's data
# sheet, dense rates): 67 TFLOP/s float32 outside the tensor cores, and
# 3.35 TB/s of HBM3.  Integer operations are counted at the float32 rate.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# The resource columns a pod requests here (CPU, memory).
RESOURCES = 2


def choose_bound_s(b: int, n: int, r: int = RESOURCES, widths=(), active: int | None = None) -> tuple[float, str]:
    """Least time of one pass of kernel #1: ``b`` pods (``active`` of them
    pending, all when None) against ``n`` nodes.  Per (active pod, node)
    pair: r fit compares, 2 ops per bitmap dot-product term (``widths``),
    and 45 scalar ops.  Bytes: each active pod's rows, every pod's flag and
    outputs, each node row once.  Returns (seconds, which bound sets it)."""
    a = b if active is None else active
    w = sum(widths)
    nbytes = a * (4 * r + 4 * w + 12) + b * (1 + 4 + 1 + 4) + n * (8 * r + 1 + 4 * w)
    ops = a * n * (r + 2 * w + 45)
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32_OPS
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
