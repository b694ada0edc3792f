"""The auction's hot op — choose: feasibility + score + masked argmax for one
block of pods against every node.

``choose_block`` is the dispatching wrapper.  For tensors on the CPU it runs
:func:`choose_block_plain`; for CUDA tensors it launches the hand-written
kernel in ``csrc/choose.cu`` (which replaces the JAX package's Pallas kernel,
``tpu_scheduler/ops/pallas_choose.py::choose_block_pallas``) or raises — it
never falls back to the plain version on the card.

The kernel is built at first use with ``nvcc`` for ``sm_90a`` into
``build/torch_kernels/`` of the checkout (one subdirectory per source
digest) and bound with ``ctypes``: a plain C launcher, no PyTorch headers,
so the build takes seconds.  ``LAUNCHES`` counts kernel launches, so a run
can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import numpy as np
import torch

from .masks import feasibility_block
from .score import score_block

__all__ = ["choose_block", "choose_block_plain", "build_library", "KernelError", "LAUNCHES"]

# Kernel launches since the counter was last set to 0 (only choose_block's
# CUDA branch adds to it, once per launch).
LAUNCHES = 0

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "choose.cu"
_BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
_LIB_NAME = "libtpu_scheduler_torch_kernels.so"


class KernelError(RuntimeError):
    """The choose kernel could not be built, loaded or launched."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelError("nvcc not found: the choose kernel is built from csrc/choose.cu at first use")


def build_library() -> tuple[pathlib.Path, float, str]:
    """Build (or find built) the kernel library for this source.  Returns
    (path, build seconds — 0.0 when already built, compiler output)."""
    src = _SOURCE.read_bytes()
    out_dir = _BUILD_ROOT / hashlib.sha256(src).hexdigest()[:16]
    lib = out_dir / _LIB_NAME
    if lib.exists():
        return lib, 0.0, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{_LIB_NAME}.{os.getpid()}"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-fmad=false",  # no FMA contraction: results must round like the unfused reference tree
        "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(_SOURCE),
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, seconds, proc.stdout + proc.stderr


@functools.cache
def _library() -> ctypes.CDLL:
    path, _, _ = build_library()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise KernelError(f"cannot load {path}: {e}") from e
    ptr, i32, u32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    lib.tsched_choose_launch.argtypes = [ptr] * 18 + [i32] * 8 + [f32] * 5 + [u32] * 2 + [ptr] * 4
    lib.tsched_choose_launch.restype = ctypes.c_int
    lib.tsched_error_string.argtypes = [ctypes.c_int]
    lib.tsched_error_string.restype = ctypes.c_char_p
    return lib


def choose_block_plain(
    req, sel, selc, ntol, aff, has_aff, pref_w, ntol_soft, active, ranks,
    avail, alloc, valid, labels, taints, node_aff, node_pref, taints_soft,
    weights, salt: int = 0,
):
    """The plain torch version: masks.feasibility_block + score.score_block
    + ``torch.argmax``, which returns the FIRST index among equal maxima
    (jnp.argmax's rule) and 0 for an all ``-inf`` row.  Returns (choice [B]
    int32, has [B] bool, best [B] float32 — the score at ``choice``, −inf
    where nothing is feasible)."""
    if req.is_cuda:
        # The count matmuls are exact only in full float32: TF32 keeps ten
        # mantissa bits, and must never be trusted silently.
        torch.backends.cuda.matmul.allow_tf32 = False
    w = torch.as_tensor(np.asarray(weights, dtype=np.float32), device=req.device)
    m = feasibility_block(req, sel, selc, active, avail, labels, valid, ntol, taints, aff, has_aff, node_aff)
    node_idx = torch.arange(avail.shape[0], device=req.device)
    sc = score_block(
        req, alloc, avail, w, ranks, node_idx,
        pod_pref_w=pref_w, node_pref=node_pref, pod_ntol_soft=ntol_soft, node_taints_soft=taints_soft, salt=salt,
    )
    sc = torch.where(m, sc, float("-inf"))
    choice = torch.argmax(sc, dim=1)
    best = sc.gather(1, choice[:, None])[:, 0]
    return choice.to(torch.int32), m.any(dim=1), best


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def choose_block(
    req, sel, selc, ntol, aff, has_aff, pref_w, ntol_soft, active, ranks,
    avail, alloc, valid, labels, taints, node_aff, node_pref, taints_soft,
    weights, salt: int = 0,
):
    """Best feasible node per pod of one block.

    Pod side: req [B,R] int32, sel [B,L] / ntol [B,T] / aff [B,A] /
    pref_w [B,A2] / ntol_soft [B,Ts] float32, selc / has_aff [B] float32,
    active [B] bool, ranks [B] int32 (priority ranks, the jitter hash
    input).  Node side, in the packed [N, ·] layout: avail / alloc [N,R]
    int32, valid [N] bool, labels [N,L] / taints [N,T] / node_aff [N,A] /
    node_pref [N,A2] / taints_soft [N,Ts] float32.  ``weights``: the
    profile's float32 weight vector (host); ``salt``: the auction round.
    Returns (choice [B] int32, has [B] bool, best [B] float32)."""
    global LAUNCHES
    device = req.device
    if device.type == "cpu":
        return choose_block_plain(
            req, sel, selc, ntol, aff, has_aff, pref_w, ntol_soft, active, ranks,
            avail, alloc, valid, labels, taints, node_aff, node_pref, taints_soft, weights, salt,
        )
    if device.type != "cuda":
        raise ValueError(f"choose_block: unsupported device {device}")
    b, r = req.shape
    n = avail.shape[0]
    widths = (sel.shape[1], ntol.shape[1], aff.shape[1], pref_w.shape[1], ntol_soft.shape[1])
    L, T, A, A2, Ts = widths
    f32, i32 = torch.float32, torch.int32
    for name, t, dtype, shape in (
        ("req", req, i32, (b, r)), ("sel", sel, f32, (b, L)), ("selc", selc, f32, (b,)),
        ("ntol", ntol, f32, (b, T)), ("aff", aff, f32, (b, A)), ("has_aff", has_aff, f32, (b,)),
        ("pref_w", pref_w, f32, (b, A2)), ("ntol_soft", ntol_soft, f32, (b, Ts)),
        ("active", active, torch.bool, (b,)), ("ranks", ranks, i32, (b,)),
        ("avail", avail, i32, (n, r)), ("alloc", alloc, i32, (n, r)), ("valid", valid, torch.bool, (n,)),
        ("labels", labels, f32, (n, L)), ("taints", taints, f32, (n, T)), ("node_aff", node_aff, f32, (n, A)),
        ("node_pref", node_pref, f32, (n, A2)), ("taints_soft", taints_soft, f32, (n, Ts)),
    ):
        _check(name, t, dtype, shape, device)
    if r < 2:
        raise ValueError("choose_block: need at least the cpu and memory resource columns")
    choice = torch.empty((b,), dtype=i32, device=device)
    has = torch.empty((b,), dtype=torch.bool, device=device)
    best = torch.empty((b,), dtype=f32, device=device)
    if b == 0:
        return choice, has, best
    lib = _library()
    w = np.asarray(weights, dtype=np.float32)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.tsched_choose_launch(
            req.data_ptr(), sel.data_ptr(), selc.data_ptr(), ntol.data_ptr(), aff.data_ptr(),
            has_aff.data_ptr(), pref_w.data_ptr(), ntol_soft.data_ptr(), active.data_ptr(), ranks.data_ptr(),
            avail.data_ptr(), alloc.data_ptr(), valid.data_ptr(), labels.data_ptr(), taints.data_ptr(),
            node_aff.data_ptr(), node_pref.data_ptr(), taints_soft.data_ptr(),
            b, n, r, L, T, A, A2, Ts,
            float(w[0]), float(w[1]), float(w[2]), float(w[3]), float(w[4]), int(salt) & 0xFFFFFFFF, 0,
            choice.data_ptr(), has.data_ptr(), best.data_ptr(), stream,
        )
    if err != 0:
        raise KernelError(f"choose kernel launch failed: {lib.tsched_error_string(err).decode()} ({err})")
    LAUNCHES += 1
    return choice, has, best
