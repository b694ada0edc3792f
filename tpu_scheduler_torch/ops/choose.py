"""The auction's hot op — choose: feasibility + score + masked argmax for one
block of pods against every node.

Two dispatching wrappers, one per kernel of ``csrc/choose.cu``:

* ``choose_block`` — the unconstrained choose (replaces the JAX package's
  ``tpu_scheduler/ops/pallas_choose.py::choose_block_pallas`` with
  ``_make_choose_kernel(False)``);
* ``choose_block_constrained`` — the same plus the inter-pod constraint
  terms of one auction round: nodes blocked by anti-affinity, hard spread
  and positive affinity, and the soft-spread, hard-spread-level and
  preferred inter-pod score terms (replaces ``_make_choose_kernel(True)``).

Both take the gang co-placement term of a topology cycle as an optional
operand, ``topo=(pod_gang_id, T)``: the block's gang ids [B] int32 and the
round's [G+1, N] float32 term (topology/locality.gang_topology_term), added
to each pod's score last.  The JAX package runs topology cycles on its jnp
tree (``tpu_scheduler/ops/assign.py:229-233``); here the term goes into the
same kernels as one more operand, in instances of their own
(``choose_kernel<·, ·, true>``), so launches without it are unchanged.
Gang ids outside [0, G] raise ValueError (:func:`check_gang_ids`).

For tensors on the CPU each runs its plain torch version
(:func:`choose_block_plain`, :func:`choose_block_constrained_plain`); for
CUDA tensors it launches its kernel or raises — it never falls back to the
plain version on the card.

The kernels read the node bitmaps as words: :func:`pack_node_words` turns
each [N, W] 0/1 bitmap into [ceil(W/32), N] int32 words (bit k of word j is
column 32·j + k), once per cycle in ``ops/assign.assign_cycle`` and once per
shard in ``parallel/sharded.py``, which pass them to every launch as
``node_words``; a direct caller may leave it out and the wrapper builds
them.  Either way every bitmap operand — node side here, pod side
(``pod_sel``, ``pod_ntol``, ``pod_aff``, ``pod_ntol_soft``) by
:func:`check_pod_bitmaps` — must hold only 0.0 and 1.0, as
``ops/pack.pack_snapshot`` makes them: the kernels count bits, which equals
the plain version's float dot products only then.  Anything else raises
``ValueError`` naming the operand, on the CPU too.

Both kernels are built at first use, by one ``nvcc`` call for ``sm_90a``,
into ``build/torch_kernels/`` of the checkout (one subdirectory per source
digest) and bound with ``ctypes``: plain C launchers, no PyTorch headers,
so the build takes seconds.  ``LAUNCHES`` and ``LAUNCHES_CONSTRAINED``
count each kernel's launches without the gang term, ``LAUNCHES_TOPO`` and
``LAUNCHES_CONSTRAINED_TOPO`` those with it, so a run can show that its
main path went through the kernels.

``node_offset`` shifts the jitter hash's node indices when the node tensors
are one tp shard of a mesh (parallel/sharded.py: the per-shard choose that
replaces ``choose_block_pallas(..., node_offset=, return_best=True)``); the
returned ``choice`` stays local to the slice and ``best`` is the score the
cross-shard merge compares.  The JAX kernel carries the offset as a float32
(``pallas_choose.py:451``, read back at ``:303``), exact only below 2^24, so
larger offsets are refused.
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

from .constraints import blocked_block
from .masks import feasibility_block
from .score import score_block

__all__ = [
    "choose_block",
    "choose_block_plain",
    "choose_block_constrained",
    "choose_block_constrained_plain",
    "constrained_node_operands",
    "constrained_pod_operands",
    "tile_live_columns",
    "tile_live_mask",
    "CONSTRAINT_POD_KEYS",
    "bind_library",
    "build_library",
    "bitmap_words",
    "check_bitmaps",
    "check_gang_ids",
    "check_pod_bitmaps",
    "pack_node_words",
    "pow2_reciprocal",
    "KernelError",
    "NODE_WORD_KEYS",
    "POD_BITMAP_KEYS",
    "LAUNCHES",
    "LAUNCHES_CONSTRAINED",
    "LAUNCHES_TOPO",
    "LAUNCHES_CONSTRAINED_TOPO",
    "MAX_NODE_OFFSET",
]

# Kernel launches since the counter was last set to 0: each wrapper's CUDA
# branch adds one to its own counter per launch, and nothing else does.
LAUNCHES = 0
LAUNCHES_CONSTRAINED = 0
LAUNCHES_TOPO = 0
LAUNCHES_CONSTRAINED_TOPO = 0

# The constraint pod bitmaps (ops/constraints.ConstraintSet.pod_arrays keys)
# the constrained choose reads for one block.
CONSTRAINT_POD_KEYS = (
    "pod_aa_carries",
    "pod_aa_matched",
    "pod_sp_declares",
    "pod_pa_declares",
    "pod_pa_matched",
    "pod_sps_declares",
    "pod_ppa_w",
)

# The node bitmaps the kernels read as words, in pack_node_words' order, and
# the pod bitmaps check_pod_bitmaps holds to 0/1 (device_arrays names).
NODE_WORD_KEYS = ("node_labels", "node_taints", "node_aff", "node_pref", "node_taints_soft")
POD_BITMAP_KEYS = ("pod_sel", "pod_ntol", "pod_aff", "pod_ntol_soft")

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "choose.cu"
_BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
_LIB_NAME = "libtpu_scheduler_torch_kernels.so"
# Offsets at or above this are not exact in the JAX kernel's float32 slot.
MAX_NODE_OFFSET = 1 << 24


class KernelError(RuntimeError):
    """A kernel could not be built, loaded or launched."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelError("nvcc not found: the kernels are built from csrc/*.cu at first use")


def build_library(source: pathlib.Path = _SOURCE, lib_name: str = _LIB_NAME) -> tuple[pathlib.Path, float, str]:
    """Build (or find built) the kernel library of one CUDA source (default:
    csrc/choose.cu) into build/torch_kernels/<source digest>/.  Returns
    (path, build seconds — 0.0 when already built, compiler output)."""
    src = source.read_bytes()
    out_dir = _BUILD_ROOT / hashlib.sha256(src).hexdigest()[:16]
    lib = out_dir / lib_name
    if lib.exists():
        return lib, 0.0, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{lib_name}.{os.getpid()}"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-fmad=false",  # no FMA contraction: results must round like the unfused reference tree
        "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(source),
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, seconds, proc.stdout + proc.stderr


def bind_library(path: pathlib.Path) -> ctypes.CDLL:
    """Load a built choose library and declare its launchers' C types."""
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise KernelError(f"cannot load {path}: {e}") from e
    ptr, i32, u32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    lib.tsched_choose_launch.argtypes = [ptr] * 20 + [i32] * 8 + [f32] * 6 + [i32] + [u32] * 2 + [ptr] * 4
    lib.tsched_choose_launch.restype = ctypes.c_int
    lib.tsched_choose_constrained_launch.argtypes = (
        [ptr] * 28 + [i32] * 12 + [f32] * 6 + [i32] + [f32] + [u32] * 2 + [ptr] * 4
    )
    lib.tsched_choose_constrained_launch.restype = ctypes.c_int
    lib.tsched_error_string.argtypes = [ctypes.c_int]
    lib.tsched_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return bind_library(build_library()[0])


def _check_offset(node_offset: int) -> int:
    node_offset = int(node_offset)
    if not 0 <= node_offset < MAX_NODE_OFFSET:
        raise ValueError(f"node_offset {node_offset} outside [0, 2^24): the reference kernel carries it as a float32")
    return node_offset


def bitmap_words(bits: torch.Tensor) -> torch.Tensor:
    """[N, W] 0/1 bitmap → [ceil(W/32), N] int32 words, on the bitmap's
    device: bit k of word j is column 32·j + k (bit 31 is the sign bit), and
    the words are transposed so that a thread per node reads them
    coalesced.  Non-zero counts as 1; :func:`check_bitmaps` first."""
    n, w = bits.shape
    nw = -(-w // 32)
    b = torch.zeros((n, nw * 32), dtype=torch.int64, device=bits.device)
    b[:, :w] = bits != 0
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (b.view(n, nw, 32) << shifts).sum(dim=2)  # distinct powers of two: the sum is the OR
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)  # as int32 bits
    return words.to(torch.int32).T.contiguous()


def check_bitmaps(bitmaps: dict) -> None:
    """Raise ValueError naming the first operand of ``bitmaps`` (name →
    tensor) that holds a value other than exactly 0.0 or 1.0 (−0.0 counts
    as 0.0).  One host read for all of them."""
    bad = torch.stack([((t != 0) & (t != 1)).any() for t in bitmaps.values()]).tolist()
    for (name, t), b in zip(bitmaps.items(), bad):
        if b:
            value = float(t[(t != 0) & (t != 1)][0])
            raise ValueError(
                f"{name}: holds {value!r}; the choose kernels count bits, so every bitmap operand must be 0.0 or 1.0"
            )


def check_gang_ids(pod_gang_id: torch.Tensor, rows: int) -> None:
    """Raise ValueError unless every gang id lies in [0, ``rows``): the
    kernels read row ``gid`` of the [rows, N] gang term unchecked.  One
    host read."""
    if pod_gang_id.numel() and bool(((pod_gang_id < 0) | (pod_gang_id >= rows)).any()):
        bad = int(pod_gang_id[(pod_gang_id < 0) | (pod_gang_id >= rows)][0])
        raise ValueError(f"pod_gang_id: holds {bad}, outside the gang term's rows [0, {rows})")


def check_pod_bitmaps(sel, ntol, aff, ntol_soft) -> None:
    """:func:`check_bitmaps` on the pod side's four bitmaps (pref_w holds
    weights and is not one)."""
    check_bitmaps(dict(zip(POD_BITMAP_KEYS, (sel, ntol, aff, ntol_soft))))


def pack_node_words(labels, taints, node_aff, node_pref, taints_soft) -> tuple:
    """The node side's five [N, W] bitmaps, checked to be 0/1
    (:func:`check_bitmaps`, ValueError otherwise), as :func:`bitmap_words`
    — the ``node_words`` the kernels read, in NODE_WORD_KEYS order.  The
    five are packed together, each padded to whole words, so a cycle pays
    one pass and one host read."""
    bitmaps = dict(zip(NODE_WORD_KEYS, (labels, taints, node_aff, node_pref, taints_soft)))
    nws = [-(-t.shape[1] // 32) for t in bitmaps.values()]
    joined = torch.zeros((labels.shape[0], 32 * sum(nws)), dtype=torch.float32, device=labels.device)
    col = 0
    for t, nw in zip(bitmaps.values(), nws):
        joined[:, col : col + t.shape[1]] = t
        col += 32 * nw
    if bool(((joined != 0) & (joined != 1)).any()):
        check_bitmaps(bitmaps)  # names the operand
    return tuple(torch.split(bitmap_words(joined), nws))


def pow2_reciprocal(w: float) -> float | None:
    """1 / w when w > 0 is a power of two whose reciprocal is a finite
    float32 (then s / w and s · (1 / w) round the same real number, so
    they are equal bit for bit); None otherwise, and the kernel divides."""
    w = np.float32(w)
    if not (np.isfinite(w) and w > 0):
        return None
    with np.errstate(over="ignore"):
        inv = np.float32(1.0) / w
    # inv · w is exact in float64; it is 1 only when inv is exactly 1 / w.
    return float(inv) if np.isfinite(inv) and float(inv) * float(w) == 1.0 else None


def _plain(args, weights, salt, node_offset=0, blocked=None, score_terms=None, topo=None):
    """feasibility (minus ``blocked``) + score (plus ``score_terms`` and the
    gang term ``topo``) + ``torch.argmax``, which returns the FIRST index
    among equal maxima (jnp.argmax's rule) and 0 for an all ``-inf`` row.
    The jitter hash reads node indices ``node_offset + [0, N)``."""
    (req, sel, selc, ntol, aff, has_aff, pref_w, ntol_soft, active, ranks,
     avail, alloc, valid, labels, taints, node_aff, node_pref, taints_soft) = args
    if req.is_cuda:
        # The count matmuls are exact only in full float32: TF32 keeps ten
        # mantissa bits, and must never be trusted silently.
        torch.backends.cuda.matmul.allow_tf32 = False
    w = torch.as_tensor(np.asarray(weights, dtype=np.float32), device=req.device)
    m = feasibility_block(req, sel, selc, active, avail, labels, valid, ntol, taints, aff, has_aff, node_aff)
    if blocked is not None:
        m = m & ~blocked
    node_idx = torch.arange(avail.shape[0], device=req.device) + _check_offset(node_offset)
    if topo is not None:
        score_terms = dict(score_terms or {}, pod_gang_id=topo[0], topo_gang_node=topo[1])
    sc = score_block(
        req, alloc, avail, w, ranks, node_idx,
        pod_pref_w=pref_w, node_pref=node_pref, pod_ntol_soft=ntol_soft, node_taints_soft=taints_soft, salt=salt,
        **(score_terms or {}),
    )
    sc = torch.where(m, sc, float("-inf"))
    choice = torch.argmax(sc, dim=1)
    best = sc.gather(1, choice[:, None])[:, 0]
    return choice.to(torch.int32), m.any(dim=1), best


def choose_block_plain(
    req, sel, selc, ntol, aff, has_aff, pref_w, ntol_soft, active, ranks,
    avail, alloc, valid, labels, taints, node_aff, node_pref, taints_soft,
    weights, salt: int = 0, node_offset: int = 0, topo=None,
):
    """The plain torch version: masks.feasibility_block + score.score_block
    (with the gang term ``topo`` when given) + argmax.  Returns (choice [B]
    int32, has [B] bool, best [B] float32 — the score at ``choice``, −inf
    where nothing is feasible)."""
    args = (req, sel, selc, ntol, aff, has_aff, pref_w, ntol_soft, active, ranks,
            avail, alloc, valid, labels, taints, node_aff, node_pref, taints_soft)
    return _plain(args, weights, salt, node_offset, topo=topo)


def choose_block_constrained_plain(
    req, sel, selc, ntol, aff, has_aff, pref_w, ntol_soft, active, ranks,
    avail, alloc, valid, labels, taints, node_aff, node_pref, taints_soft,
    cons_pod: dict, masks: dict, weights, salt: int = 0, node_offset: int = 0, topo=None,
):
    """The plain torch version of the constrained choose: feasibility &
    ~constraints.blocked_block, then score_block with the round's constraint
    terms (each present iff its mask is) and the gang term ``topo`` when
    given, then argmax.  ``cons_pod``: the
    block's CONSTRAINT_POD_KEYS bitmaps; ``masks``: the round's
    constraints.round_blocked_masks."""
    args = (req, sel, selc, ntol, aff, has_aff, pref_w, ntol_soft, active, ranks,
            avail, alloc, valid, labels, taints, node_aff, node_pref, taints_soft)
    soft_sp, soft_pa = "sp_penalty_node" in masks, "ppa_cnt_node" in masks
    terms = dict(
        pod_sps_declares=cons_pod["pod_sps_declares"] if soft_sp else None,
        sp_penalty_node=masks.get("sp_penalty_node"),
        pod_sp_declares=cons_pod["pod_sp_declares"],
        sp_level_node=masks["sp_level_node"],
        pod_ppa_w=cons_pod["pod_ppa_w"] if soft_pa else None,
        ppa_cnt_node=masks.get("ppa_cnt_node"),
    )
    return _plain(args, weights, salt, node_offset, blocked_block(cons_pod, masks), terms, topo)


def constrained_node_operands(masks: dict) -> tuple:
    """The constrained kernel's four node-side operands, each [rows, N]
    float32 and contiguous (the layout round_blocked_masks produces, so
    threads striding over nodes read them coalesced): the blocked band
    [aa_m_node; aa_c_node; sp_node; pa_unmatched_node], the soft-spread
    penalty, the hard-spread level, the preferred inter-pod counts.  A
    feature absent from the cycle has 0 rows (copied from the JAX package's
    constrained_kernel_node_operands, which zero-fills them instead)."""
    band = [masks["aa_m_node"], masks["aa_c_node"], masks["sp_node"]]
    if "pa_unmatched_node" in masks:
        band.append(masks["pa_unmatched_node"])
    empty = masks["sp_level_node"].new_zeros((0, masks["sp_level_node"].shape[1]))
    return (
        torch.cat(band).contiguous(),
        masks.get("sp_penalty_node", empty).contiguous(),
        masks["sp_level_node"].contiguous(),
        masks.get("ppa_cnt_node", empty).contiguous(),
    )


def constrained_pod_operands(cons_pod: dict, masks: dict) -> tuple:
    """The four pod-side operands matching :func:`constrained_node_operands`,
    each [B, cols] float32 and contiguous.  The positive-affinity bootstrap
    gate ``declares · (1 − matched · pa_inactive)`` is applied here, pod
    side, so the kernel's blocked sum sees the gated bitmap (copied from the
    JAX package's constrained_kernel_pod_operands)."""
    band = [cons_pod["pod_aa_carries"], cons_pod["pod_aa_matched"], cons_pod["pod_sp_declares"]]
    if "pa_unmatched_node" in masks:
        pa_inactive = masks["pa_inactive"]
        band.append(cons_pod["pod_pa_declares"] * (1.0 - cons_pod["pod_pa_matched"] * pa_inactive[None, :]))
    spd = cons_pod["pod_sp_declares"]
    empty = spd.new_zeros((spd.shape[0], 0))
    return (
        torch.cat(band, dim=1).contiguous(),
        cons_pod["pod_sps_declares"].contiguous() if "sp_penalty_node" in masks else empty,
        spd.contiguous(),
        cons_pod["pod_ppa_w"].contiguous() if "ppa_cnt_node" in masks else empty,
    )


def tile_live_mask(pod_operand: torch.Tensor, active: torch.Tensor, pods: int = 8) -> torch.Tensor:
    """[tiles, W] bool: column k is live in a ``pods``-pod tile of one
    [B, W] constrained pod operand when some ACTIVE pod of the tile has a
    non-zero value there (the constrained kernel's rule; the last tile is
    padded with inactive pods).  ``.sum(1)`` is each tile's list length."""
    b, w = pod_operand.shape
    tiles = -(-b // pods)
    nz = torch.zeros((tiles * pods, w), dtype=torch.bool, device=pod_operand.device)
    nz[:b] = (pod_operand != 0) & active[:, None]
    return nz.view(tiles, pods, w).any(dim=1)


def tile_live_columns(pod_operand: torch.Tensor, active: torch.Tensor, pods: int = 8) -> list[torch.Tensor]:
    """Each tile's ascending live columns (:func:`tile_live_mask`), one int64
    tensor per tile.  The kernel's node walk visits only these columns; the
    sums over them equal the full-width sums for every active pod, since
    every other product is ±0."""
    live = tile_live_mask(pod_operand, active, pods)
    return list(torch.split(live.nonzero()[:, 1], live.sum(dim=1).tolist()))


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_base(args) -> tuple:
    """Device, type, shape and contiguity of the 18 base operands; returns
    (device, B, N, R, (L, T, A, A2, Ts))."""
    (req, sel, selc, ntol, aff, has_aff, pref_w, ntol_soft, active, ranks,
     avail, alloc, valid, labels, taints, node_aff, node_pref, taints_soft) = args
    device = req.device
    b, r = req.shape
    n = avail.shape[0]
    L, T, A, A2, Ts = (sel.shape[1], ntol.shape[1], aff.shape[1], pref_w.shape[1], ntol_soft.shape[1])
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
    return device, b, n, r, (L, T, A, A2, Ts)


def _words(args, node_words):
    """The node words a launch reads.  Given ``node_words`` (the caller
    checked the bitmaps), their device, type and shape are checked and they
    are returned as given.  Without them every bitmap operand is checked to
    be 0/1 and, for CUDA tensors only, the words are built (the plain
    version on the CPU reads the bitmaps themselves): returns None there."""
    device, n = args[0].device, args[10].shape[0]
    widths = tuple(args[i].shape[1] for i in (1, 3, 4, 6, 7))  # L, T, A, A2, Ts
    if node_words is not None:
        node_words = tuple(node_words)
        if len(node_words) != len(NODE_WORD_KEYS):
            raise ValueError(f"node_words: {len(node_words)} tensors, expected {len(NODE_WORD_KEYS)}")
        for name, words, width in zip(NODE_WORD_KEYS, node_words, widths):
            _check(f"{name} words", words, torch.int32, (-(-width // 32), n), device)
        return node_words
    sel, ntol, aff, ntol_soft = args[1], args[3], args[4], args[7]
    check_pod_bitmaps(sel, ntol, aff, ntol_soft)
    if device.type == "cpu":
        check_bitmaps(dict(zip(NODE_WORD_KEYS, args[13:18])))
        return None
    return pack_node_words(*args[13:18])


def _check_topo(topo, b: int, n: int, device: torch.device) -> tuple:
    """Device, type, shape and contiguity of the gang term's operands."""
    gid, t = topo
    _check("pod_gang_id", gid, torch.int32, (b,), device)
    _check("topo", t, torch.float32, (t.shape[0], n), device)
    if t.shape[0] < 1:
        raise ValueError("topo: needs at least row 0 (the gangless pods' row)")
    return gid, t


def _launch(fn, name: str, args, node_words, ptrs, ints, weights, extra_floats, salt, node_offset, device, b, topo):
    """Allocate the outputs and launch one kernel on the current stream;
    raises KernelError when the launch is refused.  The pointers are the
    13 pod and node operands before the node bitmaps, the node words, the
    constraint operands ``ptrs``, then the gang ids and term of ``topo``
    (null without it); then the sizes ``ints``, the five
    weights, the jitter's exact reciprocal and its flag (pow2_reciprocal),
    ``extra_floats``.  ``node_offset`` (checked to lie in [0, 2^24)) travels
    as a c_uint32."""
    choice = torch.empty((b,), dtype=torch.int32, device=device)
    has = torch.empty((b,), dtype=torch.bool, device=device)
    best = torch.empty((b,), dtype=torch.float32, device=device)
    if b == 0:
        return choice, has, best
    w = np.asarray(weights, dtype=np.float32)
    inv = pow2_reciprocal(w[2])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            *(t.data_ptr() for t in args[:13]), *(t.data_ptr() for t in node_words), *(t.data_ptr() for t in ptrs),
            *((None, None) if topo is None else (topo[0].data_ptr(), topo[1].data_ptr())), *ints, *(float(x) for x in w[:5]), 0.0 if inv is None else inv, int(inv is not None), *extra_floats,
            int(salt) & 0xFFFFFFFF, node_offset, choice.data_ptr(), has.data_ptr(), best.data_ptr(), stream,
        )
    if err != 0:
        raise KernelError(f"{name} kernel launch failed: {_library().tsched_error_string(err).decode()} ({err})")
    return choice, has, best


def choose_block(
    req, sel, selc, ntol, aff, has_aff, pref_w, ntol_soft, active, ranks,
    avail, alloc, valid, labels, taints, node_aff, node_pref, taints_soft,
    weights, salt: int = 0, node_offset: int = 0, node_words=None, topo=None,
):
    """Best feasible node per pod of one block.

    Pod side: req [B,R] int32, sel [B,L] / ntol [B,T] / aff [B,A] /
    pref_w [B,A2] / ntol_soft [B,Ts] float32, selc / has_aff [B] float32,
    active [B] bool, ranks [B] int32 (priority ranks, the jitter hash
    input).  Node side, in the packed [N, ·] layout: avail / alloc [N,R]
    int32, valid [N] bool, labels [N,L] / taints [N,T] / node_aff [N,A] /
    node_pref [N,A2] / taints_soft [N,Ts] float32.  ``weights``: the
    profile's float32 weight vector (host); ``salt``: the auction round;
    ``node_offset``: the global index of node row 0 (a tp shard's base).
    Every bitmap (sel, ntol, aff, ntol_soft and the five node ones) must be
    0/1, else ValueError.  ``node_words``: :func:`pack_node_words` of the
    node bitmaps, built once by a caller that launches many blocks against
    one node set (its pod bitmaps then go unchecked here: the caller checks
    them once, :func:`check_pod_bitmaps`, and :func:`check_gang_ids`);
    built and checked here when None; either way they are checked against
    the node bitmaps' shapes.  ``topo``: (pod_gang_id [B] int32, T [G+1,
    N] float32 contiguous), the gang term of a topology cycle, added last.
    Returns (choice [B] int32, local to the slice; has [B] bool; best [B]
    float32)."""
    global LAUNCHES, LAUNCHES_TOPO
    args = (req, sel, selc, ntol, aff, has_aff, pref_w, ntol_soft, active, ranks,
            avail, alloc, valid, labels, taints, node_aff, node_pref, taints_soft)
    if req.device.type not in ("cpu", "cuda"):
        raise ValueError(f"choose_block: unsupported device {req.device}")
    if topo is not None and node_words is None:
        check_gang_ids(topo[0], topo[1].shape[0])
    node_words = _words(args, node_words)
    if req.device.type == "cpu":
        return _plain(args, weights, salt, node_offset, topo=topo)
    device, b, n, r, widths = _check_base(args)
    if topo is not None:
        topo = _check_topo(topo, b, n, device)
    out = _launch(
        _library().tsched_choose_launch, "choose", args, node_words, (), (b, n, r, *widths), weights, (),
        salt, _check_offset(node_offset), device, b, topo,
    )
    if b and topo is None:
        LAUNCHES += 1
    elif b:
        LAUNCHES_TOPO += 1
    return out


def choose_block_constrained(
    req, sel, selc, ntol, aff, has_aff, pref_w, ntol_soft, active, ranks,
    avail, alloc, valid, labels, taints, node_aff, node_pref, taints_soft,
    cons_pod: dict, masks: dict, weights, salt: int = 0, node_offset: int = 0, node_words=None, topo=None,
):
    """Best feasible node per pod of one block in a constrained round: the
    operands of :func:`choose_block` (``node_words``, the 0/1 rule and
    ``topo`` included), plus ``cons_pod`` (the block's CONSTRAINT_POD_KEYS bitmaps,
    [B, ·] float32) and ``masks`` (the round's
    constraints.round_blocked_masks, [·, N] float32).  Returns (choice,
    has, best) as choose_block does.  On the card each 8-pod tile sums the
    constraint terms over its live columns only (:func:`tile_live_columns`)
    and a tile with no active pod returns at once; both give the plain
    version's bits."""
    global LAUNCHES_CONSTRAINED, LAUNCHES_CONSTRAINED_TOPO
    args = (req, sel, selc, ntol, aff, has_aff, pref_w, ntol_soft, active, ranks,
            avail, alloc, valid, labels, taints, node_aff, node_pref, taints_soft)
    if req.device.type not in ("cpu", "cuda"):
        raise ValueError(f"choose_block_constrained: unsupported device {req.device}")
    if topo is not None and node_words is None:
        check_gang_ids(topo[0], topo[1].shape[0])
    node_words = _words(args, node_words)
    if req.device.type == "cpu":
        return choose_block_constrained_plain(*args, cons_pod, masks, weights, salt, node_offset, topo=topo)
    device, b, n, r, widths = _check_base(args)
    if topo is not None:
        topo = _check_topo(topo, b, n, device)
    pod_ops = constrained_pod_operands(cons_pod, masks)
    node_ops = constrained_node_operands(masks)
    names = ("blocked", "soft_spread", "spread_level", "preferred")
    for name, po, no in zip(names, pod_ops, node_ops):
        _check(f"{name} (pod)", po, torch.float32, (b, po.shape[1]), device)
        _check(f"{name} (node)", no, torch.float32, (po.shape[1], n), device)
    # Pointer order: blk_pod, blk_node, sps_pod, sps_node, spd_pod, spl_node, ppaw_pod, ppa_node.
    ptrs = [t for pair in zip(pod_ops, node_ops) for t in pair]
    w_topo = float(np.asarray(weights, dtype=np.float32)[5])
    out = _launch(
        _library().tsched_choose_constrained_launch, "choose_constrained", args, node_words,
        ptrs, (b, n, r, *widths, *(int(po.shape[1]) for po in pod_ops)), weights, (w_topo,), salt,
        _check_offset(node_offset), device, b, topo,
    )
    if b and topo is None:
        LAUNCHES_CONSTRAINED += 1
    elif b:
        LAUNCHES_CONSTRAINED_TOPO += 1
    return out
