"""The choose kernel's bisection kernels — the tools that measure its
per-pair cost one piece at a time.

Two dispatching wrappers over the kernels of ``csrc/bisect.cu``:

* ``choose_parts(..., variant)`` — the ladder of
  ``scripts/bench_kernel_parts.py`` (``make(variant)``): v0 fit only, v1 +
  the selector-count term, v2 + the LeastRequested/BalancedAllocation
  divisions, v3 + the jitter hash; an unmasked first-max argmax;
* ``choose_wide`` — ``scripts/bench_wide_kernel.py``'s choose with the pod
  features packed into one wide [P, F] float32 operand: masked
  (fit & selector count & active), LR + BA + hash, first-max argmax, 0 for a
  pod with no node.

For tensors on the CPU each runs its plain torch version
(:func:`choose_parts_plain`, :func:`choose_wide_plain`); for CUDA tensors it
launches its kernel or raises — never the plain version on the card.  The
kernels build at first use into ``build/torch_kernels/`` by one ``nvcc``
call of their own (``ops/choose.build_library`` on ``csrc/bisect.cu``).
``LAUNCHES_PARTS`` (one count per variant) and ``LAUNCHES_WIDE`` count the
launches.  The experiments that drive them at the scripts' shape are
``tpu_scheduler_torch/experiments/bench_kernel_parts.py`` and
``bench_wide_kernel.py``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .choose import _PKG, KernelError, build_library
from .score import _jitter_hash

__all__ = [
    "choose_parts",
    "choose_parts_plain",
    "choose_wide",
    "choose_wide_plain",
    "build_bisect_library",
    "LAUNCHES_PARTS",
    "LAUNCHES_WIDE",
    "WIDE_SELC_COL",
]

LAUNCHES_PARTS = [0, 0, 0, 0]
LAUNCHES_WIDE = 0

# Column of the wide pod operand that holds the selector count, and the
# pod_i32 columns: requests 0-1, active 2, rank 3.
WIDE_SELC_COL = 40
_WIDE_ACTIVE_COL, _WIDE_RANK_COL = 2, 3
_WIDE_VARIANT = 4  # the template argument of the wide kernel in csrc/bisect.cu

_SOURCE = _PKG / "csrc" / "bisect.cu"
_LIB_NAME = "libtpu_scheduler_torch_bisect.so"
# Rows of the plain version's [rows, N] intermediates per chunk: about
# 64 Mi elements, so the full-size run stays within a few GB on the card.
_PLAIN_ELEMS = 1 << 26


def build_bisect_library():
    """(path, build seconds — 0.0 when already built, compiler output)."""
    return build_library(_SOURCE, _LIB_NAME)


def bind_bisect_library(path) -> ctypes.CDLL:
    """Load a built bisection library and declare its launcher's C types."""
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise KernelError(f"cannot load {path}: {e}") from e
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tsched_bisect_launch.argtypes = [i32, ptr, i32, ptr, i32, ptr, i32, ptr, i32, ptr, ptr, i32, i32, ptr, ptr]
    lib.tsched_bisect_launch.restype = ctypes.c_int
    lib.tsched_bisect_error_string.argtypes = [ctypes.c_int]
    lib.tsched_bisect_error_string.restype = ctypes.c_char_p
    return lib


_LIB_LOCK = threading.Lock()
_LIB: list = []  # guarded-by: _LIB_LOCK — the bound library, once built


def _library() -> ctypes.CDLL:
    """The bound bisection library, built once whatever the number of
    threads whose first launch comes at the same moment."""
    if not _LIB:
        with _LIB_LOCK:
            if not _LIB:
                _LIB.append(bind_bisect_library(build_bisect_library()[0]))
    return _LIB[0]


def _fracs(req, info):
    """(frac_cpu, frac_mem) [B, N] float32: ((alloc − avail) + req) over
    max(alloc, 1), the used-capacity sum wrapping in int32 as numpy's."""
    avail, alloc = info[0:2], info[2:4]
    denom = torch.clamp(alloc, min=1).to(torch.float32)
    used_c = (alloc[0:1] - avail[0:1]) + req[:, 0:1]
    used_m = (alloc[1:2] - avail[1:2]) + req[:, 1:2]
    return used_c.to(torch.float32) / denom[0:1], used_m.to(torch.float32) / denom[1:2]


def _lr_ba(fc, fm):
    return ((1.0 - fc) + (1.0 - fm)) * 50.0, (1.0 - torch.abs(fc - fm)) * 100.0


def _jitter(ranks, n: int):
    """[B, N] float32 h / 65536 of the unsalted uint32 hash."""
    node_idx = torch.arange(n, device=ranks.device)
    return _jitter_hash(ranks[:, 0], node_idx, None).to(torch.float32) / 65536.0


def _chunks(p: int, n: int):
    step = max(1, _PLAIN_ELEMS // max(n, 1))
    return ((lo, min(p, lo + step)) for lo in range(0, p, step))


def choose_parts_plain(req, sel, selc, ranks, info, labels, variant: int):
    """The plain torch version of the ladder: [P, 1] int32, the first
    maximum of the variant's score over all nodes (torch.argmax's rule,
    jnp.argmax's too).  Runs in pod chunks to bound the [B, N]
    intermediates.  The selector counts come from a float32 matmul of 0/1
    operands: exact in any summation order, TF32 included."""
    p, n = req.shape[0], info.shape[1]
    out = torch.empty((p, 1), dtype=torch.int32, device=req.device)
    for lo, hi in _chunks(p, n):
        r = req[lo:hi]
        sc = ((r[:, 0:1] <= info[0:1]) & (r[:, 1:2] <= info[1:2])).to(torch.float32)
        if variant >= 1:
            counts = sel[lo:hi] @ labels
            sc = sc + torch.where(counts == selc[lo:hi], 1.0, 0.0)
        if variant >= 2:
            lr, ba = _lr_ba(*_fracs(r, info))
            sc = sc + lr
            sc = sc + ba
        if variant >= 3:
            sc = sc + _jitter(ranks[lo:hi], n)
        out[lo:hi, 0] = torch.argmax(sc, dim=1).to(torch.int32)
    return out


def choose_wide_plain(pod_i32, pod_f32, info, node_f32):
    """The plain torch version of the wide-operand choose: [P, 1] int32, the
    first maximum over the masked nodes, 0 for a pod with none."""
    p, n = pod_i32.shape[0], info.shape[1]
    out = torch.empty((p, 1), dtype=torch.int32, device=pod_i32.device)
    for lo, hi in _chunks(p, n):
        pi = pod_i32[lo:hi]
        fit = (pi[:, 0:1] <= info[0:1]) & (pi[:, 1:2] <= info[1:2])
        counts = pod_f32[lo:hi] @ node_f32
        mask = fit & (counts == pod_f32[lo:hi, WIDE_SELC_COL : WIDE_SELC_COL + 1])
        mask = mask & (pi[:, _WIDE_ACTIVE_COL : _WIDE_ACTIVE_COL + 1] > 0)
        lr, ba = _lr_ba(*_fracs(pi, info))
        sc = lr + ba
        sc = sc + _jitter(pi[:, _WIDE_RANK_COL : _WIDE_RANK_COL + 1], n)
        sc = torch.where(mask, sc, float("-inf"))
        out[lo:hi, 0] = torch.argmax(sc, dim=1).to(torch.int32)
    return out


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device: torch.device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{name}: {t.dtype} {tuple(t.shape)} on {t.device} (contiguous {t.is_contiguous()}), "
            f"expected contiguous {dtype} {shape} on {device}"
        )


def _launch(variant: int, pod_i, pod_i_cols, feat, selc_ptr, selc_stride, ranks_ptr, ranks_stride, info, node_f):
    p, n = pod_i.shape[0], info.shape[1]
    out = torch.empty((p, 1), dtype=torch.int32, device=pod_i.device)
    if p == 0:
        return out
    with torch.cuda.device(pod_i.device):
        stream = torch.cuda.current_stream(pod_i.device).cuda_stream
        err = _library().tsched_bisect_launch(
            variant, pod_i.data_ptr(), pod_i_cols, feat.data_ptr(), feat.shape[1], selc_ptr, selc_stride,
            ranks_ptr, ranks_stride, info.data_ptr(), node_f.data_ptr(), p, n, out.data_ptr(), stream,
        )
    if err != 0:
        raise KernelError(f"bisect kernel v{variant} launch failed: {_library().tsched_bisect_error_string(err).decode()}")
    return out


def choose_parts(req, sel, selc, ranks, info, labels, variant: int):
    """Bisection variant ``variant`` (0-3) over all nodes.  req [P, 2]
    int32, sel [P, L] / selc [P, 1] float32, ranks [P, 1] int32 (the uint32
    rank bits), info [8, N] int32 (rows 0-1 avail, 2-3 alloc), labels
    [L, N] float32.  Returns [P, 1] int32 node indices."""
    if variant not in (0, 1, 2, 3):
        raise ValueError(f"choose_parts: variant {variant} not in 0-3")
    if req.device.type == "cpu":
        return choose_parts_plain(req, sel, selc, ranks, info, labels, variant)
    if req.device.type != "cuda":
        raise ValueError(f"choose_parts: unsupported device {req.device}")
    p, n, l = req.shape[0], info.shape[1], sel.shape[1]
    f32, i32 = torch.float32, torch.int32
    for name, t, dtype, shape in (
        ("req", req, i32, (p, 2)), ("sel", sel, f32, (p, l)), ("selc", selc, f32, (p, 1)),
        ("ranks", ranks, i32, (p, 1)), ("info", info, i32, (8, n)), ("labels", labels, f32, (l, n)),
    ):
        _check(name, t, dtype, shape, req.device)
    out = _launch(variant, req, 2, sel, selc.data_ptr(), 1, ranks.data_ptr(), 1, info, labels)
    if p:
        LAUNCHES_PARTS[variant] += 1
    return out


def choose_wide(pod_i32, pod_f32, info, node_f32):
    """The wide-operand choose.  pod_i32 [P, 8] int32 (req cpu, req mem,
    active, rank, …), pod_f32 [P, F] float32 (selector count in column 40),
    info [8, N] int32, node_f32 [F, N] float32.  Returns [P, 1] int32."""
    global LAUNCHES_WIDE
    if pod_i32.device.type == "cpu":
        return choose_wide_plain(pod_i32, pod_f32, info, node_f32)
    if pod_i32.device.type != "cuda":
        raise ValueError(f"choose_wide: unsupported device {pod_i32.device}")
    p, n, f = pod_i32.shape[0], info.shape[1], pod_f32.shape[1]
    if f <= WIDE_SELC_COL:
        raise ValueError(f"choose_wide: pod_f32 needs more than {WIDE_SELC_COL} columns, has {f}")
    for name, t, dtype, shape in (
        ("pod_i32", pod_i32, torch.int32, (p, 8)), ("pod_f32", pod_f32, torch.float32, (p, f)),
        ("info", info, torch.int32, (8, n)), ("node_f32", node_f32, torch.float32, (f, n)),
    ):
        _check(name, t, dtype, shape, pod_i32.device)
    out = _launch(
        _WIDE_VARIANT, pod_i32, 8, pod_f32, pod_f32.data_ptr() + 4 * WIDE_SELC_COL, f,
        pod_i32.data_ptr() + 4 * _WIDE_RANK_COL, 8, info, node_f32,
    )
    if p:
        LAUNCHES_WIDE += 1
    return out
