"""``CudaBackend`` of the PyTorch/CUDA port: on the CPU it must schedule
exactly as the JAX package's NumPy oracle ``NativeBackend`` (bindings,
unschedulable pods, rounds, per-pod stats); it never drops to the CPU
without being asked; it refuses the cycles this slice does not carry; and
the port imports nothing of JAX or the JAX package."""

import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_scheduler.backends.native import NativeBackend
from tpu_scheduler.models.profiles import PROFILES as JAX_PROFILES
from tpu_scheduler.ops.pack import pack_snapshot as jax_pack
from tpu_scheduler.testing import synth_cluster as jax_synth
from tpu_scheduler_torch.backends.cuda import CudaBackend, make_backend
from tpu_scheduler_torch.errors import BackendUnavailable
from tpu_scheduler_torch.models.profiles import PROFILES
from tpu_scheduler_torch.ops.pack import pack_snapshot
from tpu_scheduler_torch.testing import synth_cluster

ROOT = pathlib.Path(__file__).resolve().parent.parent

MID = dict(
    selector_fraction=0.3, tainted_fraction=0.2, cordoned_fraction=0.1, node_affinity_fraction=0.3,
    soft_taint_fraction=0.3, preferred_affinity_fraction=0.3, extended_fraction=0.2,
)


def _assert_same_result(rn, rt):
    assert rt.bindings == rn.bindings
    assert rt.unschedulable == rn.unschedulable
    assert rt.rounds == rn.rounds
    np.testing.assert_array_equal(rt.assigned, rn.assigned)
    for key in ("acc_round", "rank"):
        np.testing.assert_array_equal(rt.stats[key], rn.stats[key], err_msg=key)
    assert rt.stats["backend"] == "cuda"


@pytest.mark.parametrize("features", ["plain", "all"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cpu_schedule_matches_native(seed, features):
    kw = dict(n_nodes=48, n_pending=400, n_bound=96, seed=seed, **(MID if features == "all" else {}))
    rn = NativeBackend().schedule(jax_pack(jax_synth(**kw), pod_block=64), JAX_PROFILES["throughput"].with_(pod_block=64))
    rt = CudaBackend(device="cpu").schedule(pack_snapshot(synth_cluster(**kw), pod_block=64),
                                            PROFILES["throughput"].with_(pod_block=64))
    _assert_same_result(rn, rt)


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_every_profile_with_soft_terms_matches_native(profile):
    """Every profile with soft taints, preferred affinity and extended
    resources on, against the NumPy oracle (the float32 op order of the
    reference tree, with no multiply-add contraction)."""
    kw = dict(n_nodes=24, n_pending=200, n_bound=48, seed=5, soft_taint_fraction=0.3,
              preferred_affinity_fraction=0.3, extended_fraction=0.2)
    rn = NativeBackend().schedule(jax_pack(jax_synth(**kw)), JAX_PROFILES[profile].with_(pod_block=64, max_rounds=64))
    rt = CudaBackend(device="cpu").schedule(pack_snapshot(synth_cluster(**kw)),
                                            PROFILES[profile].with_(pod_block=64, max_rounds=64))
    _assert_same_result(rn, rt)


@pytest.mark.parametrize("driver", ["auto", "monolithic", "epochs"])
def test_every_driver_value_maps_to_one_driver(driver):
    kw = dict(n_nodes=16, n_pending=200, n_bound=16, seed=4)
    rn = NativeBackend().schedule(jax_pack(jax_synth(**kw)), JAX_PROFILES["default"].with_(pod_block=64))
    rt = CudaBackend(device="cpu").schedule(pack_snapshot(synth_cluster(**kw)),
                                            PROFILES["default"].with_(pod_block=64, driver=driver))
    _assert_same_result(rn, rt)


def test_no_cuda_raises(monkeypatch):
    """Without CUDA the entry points raise; they never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(BackendUnavailable):
        CudaBackend()
    with pytest.raises(BackendUnavailable):
        make_backend("cuda")
    with pytest.raises(ValueError):
        make_backend("tpu")
    with pytest.raises(ValueError):
        CudaBackend(device="meta")


@pytest.mark.parametrize("field", ["constraints", "topology"])
def test_constrained_or_topology_cycle_raises(field):
    packed = pack_snapshot(synth_cluster(n_nodes=8, n_pending=20, seed=0))
    with pytest.raises(NotImplementedError):
        CudaBackend(device="cpu").assign(dataclasses.replace(packed, **{field: object()}), PROFILES["default"])


def test_port_imports_no_jax():
    """In a fresh interpreter, the port (every submodule) and chip_smoke.py
    load no jax module and no tpu_scheduler module."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import tpu_scheduler_torch\n"
        "for m in pkgutil.walk_packages(tpu_scheduler_torch.__path__, 'tpu_scheduler_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith(('jax.', 'jaxlib', 'tpu_scheduler.'))\n"
        "       or n == 'tpu_scheduler']\n"
        "print(json.dumps({'bad': bad, 'n': len([n for n in sys.modules if n.startswith('tpu_scheduler_torch')])}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    assert report["n"] >= 15


def test_chip_smoke_refuses_without_cuda():
    """The smoke script prints no result and exits non-zero on a machine
    without CUDA."""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
