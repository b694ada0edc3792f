"""ctypes loader for the native packing shim — the port of
``tpu_scheduler/ops/native_ext.py``.

The shim is the C++ equivalent of the reference's native kube_quantity
arithmetic (``src/util.rs:17-36``): batch quantity parsing and request-row
packing.  Python (``api/quantity.py``) remains the semantic oracle; nothing
in the port calls the shim on a cycle, as nothing in the JAX package does.
It is a host shim, not a kernel.

The port keeps its own byte copy of the source, ``csrc/pack.cpp`` (its
comments name the JAX package's build), and builds it at first use with one
``g++ -O2 -fPIC -shared -std=c++17`` call into
``build/torch_kernels/<source digest>/`` (``ops/choose.build_cached``).  A
library named by ``TPUSCHED_NATIVE_LIB`` is loaded instead when it exists;
it must export the ``*_ex`` entry points, as every build of this source
does.  Without a compiler or a library, ``available()`` is False and the
parsers raise RuntimeError.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from functools import lru_cache

import numpy as np

from .choose import _PKG, KernelError, build_cached

__all__ = ["available", "batch_parse", "pack_requests", "build_shim", "MODE_CPU_MILLIS", "MODE_MEM_BYTES"]

MODE_CPU_MILLIS = 0
MODE_MEM_BYTES = 1

_SOURCE = _PKG / "csrc" / "pack.cpp"
_LIB_NAME = "libtpusched.so"


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise KernelError("g++ not found: the packing shim is built from csrc/pack.cpp at first use")
    return found


def build_shim():
    """Build (or find built) the shim from ``csrc/pack.cpp``; its path."""
    return build_cached(
        _SOURCE, _LIB_NAME, lambda tmp: [_gxx(), "-O2", "-fPIC", "-shared", "-std=c++17", "-o", str(tmp), str(_SOURCE)]
    )[0]


def _candidates():
    """The override when it exists, then this package's own build."""
    override = os.environ.get("TPUSCHED_NATIVE_LIB", "")
    if override and os.path.exists(override):
        yield override
    try:
        yield build_shim()
    except (KernelError, OSError):
        return


@lru_cache(maxsize=1)
def _lib():
    # The override is read lazily so setting it before first use works;
    # changing it after first use requires _lib.cache_clear().
    for path in _candidates():
        try:
            lib = ctypes.CDLL(os.path.abspath(path))
        except OSError:
            continue
        lib.tpusched_batch_parse_ex.restype = ctypes.c_int64
        lib.tpusched_batch_parse_ex.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.tpusched_pack_requests_ex.restype = ctypes.c_int64
        lib.tpusched_pack_requests_ex.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        return lib
    return None


def available() -> bool:
    return _lib() is not None


def _loaded():
    lib = _lib()
    if lib is None:
        raise RuntimeError("native shim not available: no g++ to build csrc/pack.cpp and no TPUSCHED_NATIVE_LIB")
    return lib


def _to_char_pp(strs: list[str | None]):
    arr = (ctypes.c_char_p * len(strs))()
    for i, s in enumerate(strs):
        arr[i] = None if s is None else str(s).encode()
    return arr


_I64_MAX = 2**63 - 1
_I32_MAX = 2**31 - 1


def _clamp64(v: int) -> int:
    return max(-_I64_MAX, min(_I64_MAX, v))


def _oracle(s: str, mode: int) -> int:
    """Exact Python parse in shim units (int64-clamped)."""
    from ..api.quantity import cpu_to_millis, memory_to_bytes

    return _clamp64(cpu_to_millis(s) if mode == MODE_CPU_MILLIS else memory_to_bytes(s))


def batch_parse(strs: list[str], mode: int) -> np.ndarray:
    """Parse quantities to int64 base units (millicores / bytes).

    Raises ValueError naming the first invalid quantity, matching the Python
    parser's behaviour.  Entries whose >38-digit mantissas saturate the
    shim's 128-bit arithmetic are flagged by the C side and recomputed here
    through the exact Python oracle, so agreement is exact for every input.
    """
    lib = _loaded()
    out = np.zeros(len(strs), dtype=np.int64)
    inexact = np.zeros(len(strs), dtype=np.uint8)
    bad = lib.tpusched_batch_parse_ex(
        _to_char_pp(strs),
        len(strs),
        mode,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        inexact.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if bad >= 0:
        raise ValueError(f"invalid quantity: {strs[bad]!r}")
    for i in np.flatnonzero(inexact):
        out[i] = _oracle(strs[i], mode)
    return out


def pack_requests(cpu_strs: list[str | None], mem_strs: list[str | None]) -> np.ndarray:
    """[n,2] int32 (millicores, KiB-ceil) request rows — the ops/pack.py
    unit/rounding convention, computed natively.  Saturation-flagged rows are
    recomputed via the exact Python oracle (see batch_parse)."""
    lib = _loaded()
    if len(cpu_strs) != len(mem_strs):
        raise ValueError(f"pack_requests: {len(cpu_strs)} cpu and {len(mem_strs)} memory quantities")
    out = np.zeros((len(cpu_strs), 2), dtype=np.int32)
    inexact = np.zeros(len(cpu_strs), dtype=np.uint8)
    bad = lib.tpusched_pack_requests_ex(
        _to_char_pp(cpu_strs),
        _to_char_pp(mem_strs),
        len(cpu_strs),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        inexact.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if bad >= 0:
        raise ValueError(f"invalid quantity in row {bad}: cpu={cpu_strs[bad]!r} mem={mem_strs[bad]!r}")
    for i in np.flatnonzero(inexact):
        cpu = _oracle(cpu_strs[i], MODE_CPU_MILLIS) if cpu_strs[i] is not None else 0
        mem = _oracle(mem_strs[i], MODE_MEM_BYTES) if mem_strs[i] is not None else 0
        # Matches the C row convention: ceil for non-negative, C-style
        # truncation toward zero for negative.
        kib = (mem + 1023) // 1024 if mem >= 0 else -((-mem) // 1024)
        out[i, 0] = max(-_I32_MAX, min(_I32_MAX, cpu))
        out[i, 1] = max(-_I32_MAX, min(_I32_MAX, kib))
    return out
