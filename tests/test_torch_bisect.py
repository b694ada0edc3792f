"""The port's bisection kernels (#3, #4) vs the JAX package's: the plain
versions of ``tpu_scheduler_torch.ops.bisect`` (what ``choose_parts`` and
``choose_wide`` run for CPU tensors) must equal, bit for bit, the Pallas
kernels of ``scripts/bench_kernel_parts.py`` (every variant) and
``scripts/bench_wide_kernel.py`` in interpret mode on the same NumPy
inputs.  The scripts run their benchmark when imported, so only their
function definitions are loaded (``ast``) and executed with small module
globals: P = 512, N = 4,096, BP = 256, TN = 2,048.  The experiments of the
port must run nothing when imported."""

import ast
import functools
import importlib
import pathlib
import types

import numpy as np
import pytest
import torch

# The suite runs in several worker processes at once: one intra-op thread
# each keeps torch from oversubscribing the CPU.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from tpu_scheduler_torch.ops import bisect as bisect_mod  # noqa: E402
from tpu_scheduler_torch.ops.bisect import (  # noqa: E402
    WIDE_SELC_COL,
    choose_parts,
    choose_parts_plain,
    choose_wide,
    choose_wide_plain,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = dict(P=512, N=4096, BP=256, TN=2048)


def _script_functions(name: str, module_globals: dict) -> dict:
    """The script's top-level ``def``s, executed in ``module_globals`` with
    the Pallas stand-in (interpret mode); nothing else of the script runs."""
    tree = ast.parse((ROOT / "scripts" / name).read_text())
    tree.body = [node for node in tree.body if isinstance(node, ast.FunctionDef)]
    stand_in = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True), BlockSpec=pl.BlockSpec,
        program_id=pl.program_id, num_programs=pl.num_programs, when=pl.when,
    )
    g = dict(module_globals, jax=jax, jnp=jnp, pl=stand_in, pltpu=pltpu, **SMALL)
    exec(compile(tree, name, "exec"), g)  # noqa: S102 — the repo's own script
    return g


def _parts_inputs(seed: int, ties: bool = False):
    """NumPy inputs of the ladder: [P,2] requests, [P,8] selectors with
    their counts, uint32 ranks spanning the whole range, [8,N] node info
    with a few capacities near INT32_MAX (the used sum wraps), [8,N]
    labels.  ``ties``: a tiny capacity range, so many nodes tie."""
    rng = np.random.default_rng(seed)
    p, n = SMALL["P"], SMALL["N"]
    req = rng.integers(1, 1000, (p, 2), dtype=np.int32)
    sel = (rng.random((p, 8)) < 0.2).astype(np.float32)
    ranks = rng.integers(0, 2**32, (p, 1), dtype=np.uint32)
    hi = 3 if ties else 100_000
    info = np.concatenate([
        rng.integers(0 if ties else 500, hi, (4, n), dtype=np.int32) * (500 if ties else 1),
        np.ones((1, n), np.int32), np.zeros((3, n), np.int32),
    ])
    if ties:
        info[0:2, :5] = 0  # no pod fits the first nodes
    else:
        info[2:4, rng.choice(n, 16, replace=False)] = np.iinfo(np.int32).max
    labels = (rng.random((8, n)) < 0.5).astype(np.float32)
    return req, sel, sel.sum(-1, keepdims=True), ranks, info, labels


@functools.cache
def _jax_parts(seed: int, ties: bool, variant: int):
    req, sel, selc, ranks, info, labels = _parts_inputs(seed, ties)
    g = _script_functions("bench_kernel_parts.py", dict(
        L=8, req=jnp.asarray(req), sel=jnp.asarray(sel), selc=jnp.asarray(selc), ranks=jnp.asarray(ranks),
        info=jnp.asarray(info), labels_t=jnp.asarray(labels),
    ))
    return np.asarray(g["make"](variant)())


def _port_parts(seed: int, ties: bool, variant: int, fn=choose_parts_plain):
    req, sel, selc, ranks, info, labels = _parts_inputs(seed, ties)
    t = torch.from_numpy
    return fn(t(req), t(sel), t(selc), t(ranks.view(np.int32)), t(info), t(labels), variant).numpy()


@pytest.mark.parametrize("variant", [0, 1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_parts_plain_matches_pallas(seed, variant):
    got = _port_parts(seed, False, variant)
    want = _jax_parts(seed, False, variant)
    assert got.shape == want.shape == (SMALL["P"], 1) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_port_parts(seed, False, variant, choose_parts), got)  # the CPU dispatch


@pytest.mark.parametrize("variant", [0, 2])
def test_parts_ties_take_the_first_maximum(variant):
    got = _port_parts(3, True, variant)
    np.testing.assert_array_equal(got, _jax_parts(3, True, variant))
    if variant == 0:
        assert len(np.unique(got)) > 1 and (got >= 5).all()  # the first fitting node, which varies


def _wide_inputs(seed: int):
    """The wide layout with more than the script's data in it: 0/1 entries
    across the first 48 pod columns and node rows (column 40 is the
    selector count and row 40 zero, so the count reads the other columns),
    20 % of the pods inactive, and pods whose selector no node matches (all
    −inf: index 0)."""
    rng = np.random.default_rng(seed)
    p, n, f = SMALL["P"], SMALL["N"], 64
    node_f32 = np.zeros((f, n), np.float32)
    node_f32[:48] = rng.random((48, n)) < 0.6
    node_f32[WIDE_SELC_COL] = 0.0
    pod_f32 = np.zeros((p, f), np.float32)
    pod_f32[:, :48] = rng.random((p, 48)) < 0.04
    pod_f32[:, WIDE_SELC_COL] = 0.0
    pod_f32[:, WIDE_SELC_COL] = pod_f32.sum(-1) + (rng.random(p) < 0.1)  # 10 %: one more than any node gives
    pod_i32 = np.zeros((p, 8), np.int32)
    pod_i32[:, 0:2] = rng.integers(1, 1000, (p, 2))
    pod_i32[:, 2] = rng.random(p) < 0.8
    pod_i32[:, 3] = rng.integers(0, 2**32, p, dtype=np.uint32).view(np.int32)
    info = np.concatenate([
        rng.integers(500, 100_000, (4, n), dtype=np.int32), np.ones((1, n), np.int32), np.zeros((3, n), np.int32),
    ])
    return pod_i32, pod_f32, info, node_f32


@pytest.mark.parametrize("seed", [0, 1])
def test_wide_plain_matches_pallas(seed):
    pod_i32, pod_f32, info, node_f32 = _wide_inputs(seed)
    g = _script_functions("bench_wide_kernel.py", dict(F=64))
    want = np.asarray(g["run"](*(jnp.asarray(x) for x in (pod_i32, pod_f32, info, node_f32))))
    t = torch.from_numpy
    got = choose_wide_plain(t(pod_i32), t(pod_f32), t(info), t(node_f32)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(choose_wide(t(pod_i32), t(pod_f32), t(info), t(node_f32)).numpy(), got)
    inactive = pod_i32[:, 2] == 0
    assert inactive.any() and (got[inactive, 0] == 0).all()
    assert (got[~inactive, 0] > 0).any()


def test_plain_chunks_equal_one_shot(monkeypatch):
    """The plain versions run in pod chunks; a chunk of a few rows gives the
    same result."""
    req, sel, selc, ranks, info, labels = (torch.from_numpy(x) for x in _parts_inputs(5))
    ranks = ranks.view(torch.int32)
    whole = [choose_parts_plain(req, sel, selc, ranks, info, labels, v) for v in range(4)]
    wide = [torch.from_numpy(x) for x in _wide_inputs(5)]
    wide_whole = choose_wide_plain(*wide)
    monkeypatch.setattr(bisect_mod, "_PLAIN_ELEMS", 3 * SMALL["N"] + 7)
    for v in range(4):
        assert torch.equal(choose_parts_plain(req, sel, selc, ranks, info, labels, v), whole[v])
    assert torch.equal(choose_wide_plain(*wide), wide_whole)


def test_wrappers_refuse_bad_calls():
    req, sel, selc, ranks, info, labels = (torch.from_numpy(x) for x in _parts_inputs(0))
    with pytest.raises(ValueError, match="variant"):
        choose_parts(req, sel, selc, ranks.view(torch.int32), info, labels, 4)
    meta = [x.to("meta") for x in (req, sel, selc, ranks.view(torch.int32), info, labels)]
    with pytest.raises(ValueError, match="unsupported device"):
        choose_parts(*meta, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        choose_wide(*(torch.from_numpy(x).to("meta") for x in _wide_inputs(0)))


@pytest.mark.parametrize("name", ["bench_kernel_parts", "bench_wide_kernel"])
def test_experiments_run_nothing_when_imported(name, monkeypatch, capsys):
    """Importing an experiment makes no data, prints nothing and touches no
    device; without CUDA its main() exits 1 with nothing measured."""
    def refuse(*_a, **_k):
        raise AssertionError("the experiment made data or timed at import")

    mod = importlib.import_module(f"tpu_scheduler_torch.experiments.{name}")
    for fn in ("randint", "rand", "zeros"):
        monkeypatch.setattr(torch, fn, refuse)
    monkeypatch.setattr(torch.cuda, "is_available", refuse)
    mod = importlib.reload(mod)
    assert capsys.readouterr().out == ""
    assert not any(isinstance(v, torch.Tensor) for v in vars(mod).values())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main([]) == 1
    assert capsys.readouterr().out == ""


def test_experiment_inputs_have_the_scripts_layout():
    from tpu_scheduler_torch.experiments import bench_kernel_parts, bench_wide_kernel

    req, sel, selc, ranks, info, labels = bench_kernel_parts.make_inputs(64, 300)
    assert req.shape == (64, 2) and sel.shape == (64, 8) and labels.shape == (8, 300) and info.shape == (8, 300)
    assert torch.equal(selc[:, 0], sel.sum(-1)) and torch.equal(ranks[:, 0], torch.arange(64, dtype=torch.int32))
    pod_i32, pod_f32, info, node_f32 = bench_wide_kernel.make_inputs(64, 300)
    assert torch.equal(pod_f32[:, WIDE_SELC_COL], pod_f32[:, :8].sum(-1)) and (pod_i32[:, 2] == 1).all()
    assert not node_f32[8:].any()
    a, b = bench_kernel_parts.make_inputs(64, 300, seed=1), bench_kernel_parts.make_inputs(64, 300, seed=1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
