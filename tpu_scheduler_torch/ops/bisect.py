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

The kernels count bits: the selector count is a popcount over the live
rows of the count operand (``labels``; ``node_f32``), so on either device a
wrapper first checks, in one host read (:func:`check_count_operands`), that
the live entries are 0.0 or 1.0 and, for the wide choose, that ``pod_f32`` is
finite, and raises ValueError naming the operand otherwise.  For tensors on
the CPU each then runs its plain torch version (:func:`choose_parts_plain`,
:func:`choose_wide_plain`, the reference's function); for CUDA tensors it
packs the node side with the live rows' words (:func:`prepare_parts`,
:func:`prepare_wide`) and launches its kernel (:func:`launch_prepared`) or
raises — never the plain version on the card.  The kernels build at first
use into ``build/torch_kernels/`` by one ``nvcc`` call of their own
(``ops/choose.build_library`` on ``csrc/bisect.cu``).  ``LAUNCHES_PARTS``
(one count per variant) and ``LAUNCHES_WIDE`` count the launches.  The
experiments that drive them at the scripts' shape are
``tpu_scheduler_torch/experiments/bench_kernel_parts.py`` and
``bench_wide_kernel.py``; ``bench_bisect_trees`` holds them against another
checkout's, ``bench_bisect_tiles`` times other tile sizes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading

import torch

from .choose import _PKG, KernelError, bitmap_words, build_library
from .score import _jitter_hash

__all__ = [
    "choose_parts",
    "choose_parts_plain",
    "choose_wide",
    "choose_wide_plain",
    "check_count_operands",
    "live_words",
    "node_operand",
    "PreparedLaunch",
    "prepare_parts",
    "prepare_wide",
    "launch_prepared",
    "pods_per_tile",
    "build_bisect_library",
    "bind_bisect_library",
    "LAUNCHES_PARTS",
    "LAUNCHES_WIDE",
    "MAX_LIVE_ROWS",
    "WIDE_SELC_COL",
]

LAUNCHES_PARTS = [0, 0, 0, 0]
LAUNCHES_WIDE = 0

# Column of the wide pod operand that holds the selector count, and the
# pod_i32 columns: requests 0-1, active 2, rank 3.
WIDE_SELC_COL = 40
_WIDE_ACTIVE_COL, _WIDE_RANK_COL = 2, 3
_WIDE_VARIANT = 4  # the template argument of the wide kernel in csrc/bisect.cu
# Live rows of the count operand a launch takes: two 32-bit words.
MAX_LIVE_ROWS = 64

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
    lib.tsched_bisect_launch.argtypes = [
        i32, ptr, i32, ptr, i32, ptr, i32, ptr, i32, ptr, ctypes.POINTER(ctypes.c_int32), i32, i32, i32, ptr, ptr,
    ]
    lib.tsched_bisect_launch.restype = ctypes.c_int
    lib.tsched_bisect_pods.argtypes = [i32]
    lib.tsched_bisect_pods.restype = ctypes.c_int
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


def check_count_operands(pod_name: str, pod: torch.Tensor, node_name: str, node: torch.Tensor,
                         live_columns_only: bool) -> list[int]:
    """The live rows of the count operand ``node`` [K, N] (those with a
    non-zero entry), ascending, after checking in one host read, as
    ``ops/choose.check_bitmaps`` does, what makes a popcount over them equal
    the float dot product ``pod @ node``: ``node`` holds only 0.0 and 1.0
    (−0.0 counts as 0.0); ``pod`` [P, K] does too — in every column, or with
    ``live_columns_only`` in the live columns alone, and then it must be
    finite everywhere (a dead row adds pod·0, exactly 0 only for a finite
    pod value).  Raises ValueError naming the operand."""
    bits = "; the bisection kernels count bits, so every live entry of the count operands must be 0.0 or 1.0"
    live = (node != 0).any(dim=1)
    pod_bad = (pod != 0) & (pod != 1)
    checks = []  # (name, tensor, bad entries, what the error says)
    if live_columns_only:
        checks.append((pod_name, pod, ~torch.isfinite(pod), "; the bisection kernels skip the count operand's zero "
                       "rows, which is exact only for a finite pod operand"))
        pod_bad = pod_bad & live
    checks.append((node_name, node, (node != 0) & (node != 1), bits))
    checks.append((pod_name, pod, pod_bad, (" in a live column" if live_columns_only else "") + bits))
    read = torch.cat([torch.stack([bad.any() for _, _, bad, _ in checks]), live]).tolist()  # the one host read
    for (name, t, bad, why), hit in zip(checks, read):
        if hit:
            raise ValueError(f"{name}: holds {float(t[bad][0])!r}{why}")
    return [k for k, v in enumerate(read[len(checks):]) if v]


def live_words(bits: torch.Tensor, live: list[int]) -> torch.Tensor:
    """[M, K] 0/1 bitmap → [ceil(len(live)/32), M] int32 words of its
    ``live`` columns: bit b of word j is column ``live[32·j + b]``,
    transposed so a thread per row reads them coalesced
    (``ops/choose.bitmap_words`` of those columns)."""
    idx = torch.tensor(live, dtype=torch.long, device=bits.device)
    return bitmap_words(bits.index_select(1, idx))


def node_operand(info: torch.Tensor, words: torch.Tensor, variant: int) -> torch.Tensor:
    """The node side of a launch, only what ``variant`` reads, flat int32:
    each node's capacities as one vector — (avail cpu, avail memory) for
    variants 0-1, + (alloc cpu, alloc memory) from variant 2 (info rows
    0-1, 0-3) — then the [nw, N] words of the count operand's live rows
    (``words``, at most two; none for variant 0)."""
    nw = words.shape[0]
    if nw > MAX_LIVE_ROWS // 32:
        raise ValueError(f"node_operand: {nw} words, the kernels read at most {MAX_LIVE_ROWS // 32}")
    caps = info[0 : 4 if variant >= 2 else 2].T.reshape(-1)
    return torch.cat([caps, words.reshape(-1)])


@dataclasses.dataclass(frozen=True)
class PreparedLaunch:
    """What one launch of a bisection kernel reads, checked and packed by
    :func:`prepare_parts` or :func:`prepare_wide`; launched by
    :func:`launch_prepared`, as often as wanted.  ``selc`` and ``ranks`` are
    read at element offsets ``*_off`` with row strides ``*_stride``."""

    variant: int
    pod_i: torch.Tensor
    pod_i_cols: int
    feat: torch.Tensor
    selc: torch.Tensor
    selc_off: int
    selc_stride: int
    ranks: torch.Tensor
    ranks_off: int
    ranks_stride: int
    nodes: torch.Tensor
    n: int
    live: tuple[int, ...]


def _packed(variant: int, node: torch.Tensor, live: list[int], info: torch.Tensor) -> torch.Tensor:
    if len(live) > MAX_LIVE_ROWS:
        raise ValueError(f"bisect kernel v{variant}: the count operand has {len(live)} live rows; "
                         f"the kernels take at most {MAX_LIVE_ROWS}")
    if variant == 0:
        words = info.new_zeros((0, info.shape[1]))
    elif live:
        words = live_words(node.T, live)
    else:  # no live row: every count is 0, and the kernels read one word plane
        words = info.new_zeros((1, info.shape[1]))
    return node_operand(info, words, variant)


def prepare_parts(req, sel, selc, ranks, info, labels, variant: int) -> PreparedLaunch:
    """Check the ladder's CUDA operands (as :func:`choose_parts` takes them)
    and pack the node side; variant 0 reads neither ``sel`` nor ``labels``."""
    if variant not in (0, 1, 2, 3):
        raise ValueError(f"choose_parts: variant {variant} not in 0-3")
    if req.device.type != "cuda":
        raise ValueError(f"prepare_parts: unsupported device {req.device}")
    p, n, l = req.shape[0], info.shape[1], sel.shape[1]
    f32, i32 = torch.float32, torch.int32
    for name, t, dtype, shape in (
        ("req", req, i32, (p, 2)), ("sel", sel, f32, (p, l)), ("selc", selc, f32, (p, 1)),
        ("ranks", ranks, i32, (p, 1)), ("info", info, i32, (8, n)), ("labels", labels, f32, (l, n)),
    ):
        _check(name, t, dtype, shape, req.device)
    live = check_count_operands("sel", sel, "labels", labels, False) if variant else []
    nodes = _packed(variant, labels, live, info)
    return PreparedLaunch(variant, req, 2, sel, selc, 0, 1, ranks, 0, 1, nodes, n, tuple(live))


def prepare_wide(pod_i32, pod_f32, info, node_f32) -> PreparedLaunch:
    """Check the wide choose's CUDA operands (as :func:`choose_wide` takes
    them) and pack the node side of ``node_f32``'s live rows."""
    if pod_i32.device.type != "cuda":
        raise ValueError(f"prepare_wide: unsupported device {pod_i32.device}")
    p, n, f = pod_i32.shape[0], info.shape[1], pod_f32.shape[1]
    if f <= WIDE_SELC_COL:
        raise ValueError(f"choose_wide: pod_f32 needs more than {WIDE_SELC_COL} columns, has {f}")
    for name, t, dtype, shape in (
        ("pod_i32", pod_i32, torch.int32, (p, 8)), ("pod_f32", pod_f32, torch.float32, (p, f)),
        ("info", info, torch.int32, (8, n)), ("node_f32", node_f32, torch.float32, (f, n)),
    ):
        _check(name, t, dtype, shape, pod_i32.device)
    live = check_count_operands("pod_f32", pod_f32, "node_f32", node_f32, True)
    nodes = _packed(_WIDE_VARIANT, node_f32, live, info)
    return PreparedLaunch(_WIDE_VARIANT, pod_i32, 8, pod_f32, pod_f32, WIDE_SELC_COL, f, pod_i32, _WIDE_RANK_COL, 8,
                          nodes, n, tuple(live))


def launch_prepared(prep: PreparedLaunch, lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """Launch the kernel of ``prep`` on the current stream (through ``lib``,
    a library bound by :func:`bind_bisect_library`, else this package's
    build) and count the launch; [P, 1] int32.  Raises KernelError when the
    launch is refused."""
    global LAUNCHES_WIDE
    lib = lib if lib is not None else _library()
    pod_i = prep.pod_i
    p, n = pod_i.shape[0], prep.n
    out = torch.empty((p, 1), dtype=torch.int32, device=pod_i.device)
    if p == 0:
        return out
    live = (ctypes.c_int32 * MAX_LIVE_ROWS)(*prep.live)
    with torch.cuda.device(pod_i.device):
        stream = torch.cuda.current_stream(pod_i.device).cuda_stream
        err = lib.tsched_bisect_launch(
            prep.variant, pod_i.data_ptr(), prep.pod_i_cols, prep.feat.data_ptr(), prep.feat.shape[1],
            prep.selc.data_ptr() + 4 * prep.selc_off, prep.selc_stride, prep.ranks.data_ptr() + 4 * prep.ranks_off,
            prep.ranks_stride, prep.nodes.data_ptr(), live, len(prep.live), p, n, out.data_ptr(), stream,
        )
    if err != 0:
        raise KernelError(f"bisect kernel v{prep.variant} launch failed: {lib.tsched_bisect_error_string(err).decode()}")
    if prep.variant == _WIDE_VARIANT:
        LAUNCHES_WIDE += 1
    else:
        LAUNCHES_PARTS[prep.variant] += 1
    return out


def pods_per_tile(variant: int, lib: ctypes.CDLL | None = None) -> int:
    """Pods per warp of ``variant``'s kernel instances (4: the wide kernel)
    in ``lib``, else this package's build."""
    return int((lib if lib is not None else _library()).tsched_bisect_pods(variant))


def choose_parts(req, sel, selc, ranks, info, labels, variant: int):
    """Bisection variant ``variant`` (0-3) over all nodes.  req [P, 2]
    int32, sel [P, L] / selc [P, 1] float32, ranks [P, 1] int32 (the uint32
    rank bits), info [8, N] int32 (rows 0-1 avail, 2-3 alloc), labels
    [L, N] float32.  Returns [P, 1] int32 node indices.  From variant 1 on,
    ``sel`` and ``labels`` must hold only 0.0 and 1.0 (ValueError otherwise,
    on either device); on the card ``labels`` may have at most 64 non-zero
    rows."""
    if variant not in (0, 1, 2, 3):
        raise ValueError(f"choose_parts: variant {variant} not in 0-3")
    if req.device.type == "cpu":
        if variant:
            check_count_operands("sel", sel, "labels", labels, False)
        return choose_parts_plain(req, sel, selc, ranks, info, labels, variant)
    if req.device.type != "cuda":
        raise ValueError(f"choose_parts: unsupported device {req.device}")
    return launch_prepared(prepare_parts(req, sel, selc, ranks, info, labels, variant))


def choose_wide(pod_i32, pod_f32, info, node_f32):
    """The wide-operand choose.  pod_i32 [P, 8] int32 (req cpu, req mem,
    active, rank, …), pod_f32 [P, F] float32 (selector count in column 40),
    info [8, N] int32, node_f32 [F, N] float32.  Returns [P, 1] int32.  The
    live rows of ``node_f32`` (those with a non-zero entry) and
    ``pod_f32``'s columns of them must hold only 0.0 and 1.0, and
    ``pod_f32`` must be finite (ValueError otherwise, on either device); on
    the card at most 64 rows may be live."""
    if pod_i32.device.type == "cpu":
        check_count_operands("pod_f32", pod_f32, "node_f32", node_f32, True)
        return choose_wide_plain(pod_i32, pod_f32, info, node_f32)
    if pod_i32.device.type != "cuda":
        raise ValueError(f"choose_wide: unsupported device {pod_i32.device}")
    return launch_prepared(prepare_wide(pod_i32, pod_f32, info, node_f32))
