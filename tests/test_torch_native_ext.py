"""The native packing shim on both packages: the port's
``tpu_scheduler_torch.ops.native_ext`` (its own copy of the source,
``tpu_scheduler_torch/csrc/pack.cpp``, built at first use into
``build/torch_kernels/<digest>/``) and the JAX package's (built by
``conftest.ensure_native_shim``), each held against the JAX quantity oracle
on every case of ``tests/test_native_ext.py`` and the shim cases of
``tests/test_review_fixes_r3.py``; and the port never loading the JAX
package's ``native/build/``."""

import ctypes
import os
import pathlib
import random

import numpy as np
import pytest

from tpu_scheduler.api.quantity import QuantityError, cpu_to_millis, memory_to_bytes
from tpu_scheduler.ops import native_ext as jax_native_ext
from tpu_scheduler_torch.ops import choose as choose_mod
from tpu_scheduler_torch.ops import native_ext as port_native_ext

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGES = ["jax", "port"]


@pytest.fixture(scope="module")
def shims():
    from conftest import ensure_native_shim

    ensure_native_shim()
    assert port_native_ext.available(), "the port's shim failed to build"
    return {"jax": jax_native_ext, "port": port_native_ext}


@pytest.fixture(params=PACKAGES)
def shim(request, shims):
    return shims[request.param]


CASES = [
    "0", "1", "2", "500m", "0.5", "1.5", "100u", "1n", "2k", "3M", "1G",
    "1Gi", "2Gi", "1.5Gi", "64Mi", "1Ki", "100m", "1Ti", "129e6", "12e-3",
    "+3M", "-2Ki", "1E", "1Ei", "0.1", "128974848", "1e3", "2E2", "-0.5",
    "999999999999", "3.14159", ".5", "5.",
]

I64_MAX = np.iinfo(np.int64).max


def clamp64(v: int) -> int:
    return max(min(v, I64_MAX), -I64_MAX)


@pytest.mark.parametrize("s", CASES)
def test_cpu_agreement(shim, s):
    assert shim.batch_parse([s], shim.MODE_CPU_MILLIS)[0] == clamp64(cpu_to_millis(s))


@pytest.mark.parametrize("s", CASES)
def test_mem_agreement(shim, s):
    assert shim.batch_parse([s], shim.MODE_MEM_BYTES)[0] == clamp64(memory_to_bytes(s))


def test_fuzz_against_python_oracle(shim):
    rng = random.Random(7)
    suffixes = ["", "n", "u", "m", "k", "M", "G", "T", "Ki", "Mi", "Gi", "Ti", "e3", "e-2", "E2"]
    strs = []
    for _ in range(3000):
        whole = rng.randrange(0, 10 ** rng.randrange(1, 10))
        if rng.random() < 0.4:
            frac = rng.randrange(0, 1000)
            base = f"{whole}.{frac}"
        else:
            base = str(whole)
        sign = rng.choice(["", "+", "-"]) if rng.random() < 0.2 else ""
        strs.append(sign + base + rng.choice(suffixes))
    got_cpu = shim.batch_parse(strs, shim.MODE_CPU_MILLIS)
    got_mem = shim.batch_parse(strs, shim.MODE_MEM_BYTES)
    for s, gc, gm in zip(strs, got_cpu, got_mem):
        assert gc == clamp64(cpu_to_millis(s)), s
        assert gm == clamp64(memory_to_bytes(s)), s


@pytest.mark.parametrize("bad", ["", "abc", "1Qi", "1.2.3", "e5", "--1", "Gi", "1 Gi", "1e"])
def test_invalid_rejected_like_python(shim, bad):
    with pytest.raises(QuantityError):
        cpu_to_millis(bad)
    with pytest.raises(ValueError, match="invalid quantity"):
        shim.batch_parse([bad], shim.MODE_CPU_MILLIS)


def test_pack_requests_rows(shim):
    out = shim.pack_requests(["500m", "2", None], ["1Gi", "1025", "64Mi"])
    assert out.dtype == np.int32
    assert out[0].tolist() == [500, 2**20]
    assert out[1].tolist() == [2000, 2]  # ceil(1025/1024)
    assert out[2].tolist() == [0, 64 * 2**10]  # None cpu -> 0


def test_pack_requests_clamps_to_int32(shim):
    out = shim.pack_requests(["4000000000"], ["8Ti"])
    assert out[0, 0] == 2**31 - 1
    assert out[0, 1] == 2**31 - 1


def test_huge_exponent_saturates(shim):
    v = shim.batch_parse(["9e30"], shim.MODE_MEM_BYTES)[0]
    assert v == np.iinfo(np.int64).max  # clamped, not wrapped
    assert memory_to_bytes("9e30") == 9 * 10**30  # python stays exact


def test_shim_huge_mantissa_matches_python(shim):
    """A 39-digit mantissa wraps unsigned __int128; the shim must saturate
    (and then clamp like the oracle), not return wrapped garbage."""
    cases = [
        "510423550381407695195061911147652317184e-24",  # wraps to >= mantissa
        "340282366920938463463374607431768211456",  # 2^128 exactly
        "99999999999999999999999999999999999999999e-30",
        "170141183460469231731687303715884105727e-20",
        "-510423550381407695195061911147652317184e-24",
        "1.00000000000000000000000000000000000000000001e2",
    ]
    for s in cases:
        assert shim.batch_parse([s], shim.MODE_CPU_MILLIS)[0] == clamp64(cpu_to_millis(s)), s
        assert shim.batch_parse([s], shim.MODE_MEM_BYTES)[0] == clamp64(memory_to_bytes(s)), s
    rows = shim.pack_requests(["99999999999999999999999999999999999999999e-30"], ["2Gi"])
    assert rows[0, 0] == min(2**31 - 1, clamp64(cpu_to_millis("99999999999999999999999999999999999999999e-30")))
    assert rows[0, 1] == 2 * 1024 * 1024


def test_packages_agree_on_pack_requests(shims):
    rng = random.Random(11)
    cpu = [rng.choice(["100m", "250m", "1", "2.5", None, "1500m", "3e2"]) for _ in range(500)]
    mem = [rng.choice(["64Mi", "1Gi", "512M", "1025", None, "3.5Gi", "1e9"]) for _ in range(500)]
    np.testing.assert_array_equal(shims["port"].pack_requests(cpu, mem), shims["jax"].pack_requests(cpu, mem))


def test_port_builds_its_own_copy_and_never_reads_native_build(monkeypatch, shims):
    """The port's source is a byte copy of native/pack.cpp; its library is
    the one built from it under build/torch_kernels/<digest>/, and a fresh
    load never opens anything under native/build/."""
    assert (ROOT / "tpu_scheduler_torch" / "csrc" / "pack.cpp").read_bytes() == (ROOT / "native" / "pack.cpp").read_bytes()
    monkeypatch.delenv("TPUSCHED_NATIVE_LIB", raising=False)
    opened = []
    real_cdll = ctypes.CDLL
    monkeypatch.setattr(ctypes, "CDLL", lambda path, *a, **k: opened.append(str(path)) or real_cdll(path, *a, **k))
    port_native_ext._lib.cache_clear()
    try:
        assert port_native_ext.batch_parse(["2Gi"], port_native_ext.MODE_MEM_BYTES)[0] == 2 * 2**30
    finally:
        port_native_ext._lib.cache_clear()
    built = port_native_ext.build_shim()
    assert opened == [os.path.abspath(built)]
    assert built.parent.parent == choose_mod._BUILD_ROOT and built.name == "libtpusched.so"
    assert "native" not in built.relative_to(ROOT).parts[:1]


def test_port_override_and_missing_library(monkeypatch, tmp_path, shims):
    """``TPUSCHED_NATIVE_LIB`` wins when it exists; without a compiler and
    without a built library the shim is unavailable and the parsers raise
    RuntimeError."""
    built = port_native_ext.build_shim()
    monkeypatch.setenv("TPUSCHED_NATIVE_LIB", str(built))
    monkeypatch.setattr(choose_mod, "_BUILD_ROOT", tmp_path / "empty")
    monkeypatch.setattr(port_native_ext.shutil, "which", lambda _name: None)
    port_native_ext._lib.cache_clear()
    try:
        assert port_native_ext.available()
        monkeypatch.delenv("TPUSCHED_NATIVE_LIB")
        port_native_ext._lib.cache_clear()
        assert not port_native_ext.available()
        with pytest.raises(RuntimeError, match="not available"):
            port_native_ext.batch_parse(["1"], port_native_ext.MODE_CPU_MILLIS)
        with pytest.raises(RuntimeError, match="not available"):
            port_native_ext.pack_requests(["1"], ["1"])
    finally:
        port_native_ext._lib.cache_clear()
