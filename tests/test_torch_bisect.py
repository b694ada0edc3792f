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


@pytest.mark.parametrize("variant", [0, 1, 2, 3])
def test_parts_ties_take_the_first_maximum(variant):
    got = _port_parts(3, True, variant)
    np.testing.assert_array_equal(got, _jax_parts(3, True, variant))
    if variant == 0:
        assert len(np.unique(got)) > 1 and (got >= 5).all()  # the first fitting node, which varies


def _wide_inputs(seed: int, rows=range(48)):
    """The wide layout with more than the script's data in it: 0/1 entries
    across the pod columns and node rows ``rows`` (default the first 48;
    column 40 is the selector count and row 40 zero, so the count reads the
    other columns), 20 % of the pods inactive, and pods whose selector no
    node matches (all −inf: index 0)."""
    rng = np.random.default_rng(seed)
    p, n, f = SMALL["P"], SMALL["N"], 64
    rows = list(rows)
    node_f32 = np.zeros((f, n), np.float32)
    node_f32[rows] = rng.random((len(rows), n)) < 0.6
    node_f32[WIDE_SELC_COL] = 0.0
    pod_f32 = np.zeros((p, f), np.float32)
    pod_f32[:, rows] = rng.random((p, len(rows))) < 0.04
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
    _wide_against_pallas(*_wide_inputs(seed))


@pytest.mark.parametrize("rows", [list(range(8)) + list(range(50, 64)), [31, 32], list(range(64))],
                         ids=["rows_0-7_50-63", "rows_31_32", "all_but_40"])
def test_wide_plain_matches_pallas_at_other_live_rows(rows):
    """Live count rows that cross the word boundary without being
    contiguous, two rows on either side of it, and every row live but the
    count column's."""
    _wide_against_pallas(*_wide_inputs(2, rows))


def _wide_against_pallas(pod_i32, pod_f32, info, node_f32):
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


@pytest.mark.parametrize("name", ["bench_kernel_parts", "bench_wide_kernel", "bench_bisect_tiles", "bisect_sass"])
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


# ---- the word packing and the wrappers' checks (what the kernels rely on) ----


def _popcount(words: np.ndarray) -> np.ndarray:
    return np.bitwise_count(words.view(np.uint32)).astype(np.int64)


@pytest.mark.parametrize("live", [
    [0], [5, 9], list(range(31)), list(range(32)), list(range(33)), [31, 32], list(range(8)) + list(range(50, 64)),
    [r for r in range(48) if r != WIDE_SELC_COL], sorted(list(range(1, 64, 2)) + [62]), list(range(63)), list(range(64)),
], ids=["1", "2", "31", "32", "33", "31_32", "0-7_50-63", "47", "33_odd", "63", "64"])
def test_live_words_popcount_equals_float_dot(live):
    """Packing only the live rows of the count operand (pod side and node
    side alike, ``live_words``) gives words whose popcount, summed over the
    words, is the float dot product of the 0/1 operands — also over every
    row, the dead ones adding zeros."""
    rng = np.random.default_rng(len(live))
    p, n, k = 40, 300, 64
    node = np.zeros((k, n), np.float32)
    node[live] = rng.random((len(live), n)) < 0.5
    node[live, 0] = 1.0  # every listed row live
    pod = (rng.random((p, k)) < 0.3).astype(np.float32)
    t = torch.from_numpy
    assert bisect_mod.check_count_operands("pod", t(pod), "node", t(node), False) == live
    pw = bisect_mod.live_words(t(pod), live).numpy()
    nw = bisect_mod.live_words(t(node).T, live).numpy()
    assert pw.shape == (-(-len(live) // 32), p) and nw.shape == (-(-len(live) // 32), n) and pw.dtype == np.int32
    counts = sum(_popcount(pw[j][:, None] & nw[j][None, :]) for j in range(pw.shape[0]))
    np.testing.assert_array_equal(counts, (pod[:, live] @ node[live]).astype(np.int64))
    np.testing.assert_array_equal(counts, (pod @ node).astype(np.int64))


def test_node_operand_layout():
    """The node side the kernels read: capacities as one vector per node
    (avail for v0-v1, avail and alloc from v2), then word planes."""
    rng = np.random.default_rng(0)
    info = torch.from_numpy(rng.integers(0, 1000, (8, 37), dtype=np.int32))
    words = torch.from_numpy(rng.integers(-(2**31), 2**31, (2, 37), dtype=np.int64).astype(np.int32))
    for variant, width in ((1, 2), (2, 4), (4, 4)):
        nodes = bisect_mod.node_operand(info, words, variant)
        assert nodes.dtype == torch.int32 and nodes.shape == (37 * (width + 2),)
        assert torch.equal(nodes[: 37 * width].view(37, width), info[0:width].T)
        assert torch.equal(nodes[37 * width :].view(2, 37), words)
    assert torch.equal(bisect_mod.node_operand(info, words[:0], 0), info[0:2].T.reshape(-1))
    with pytest.raises(ValueError, match="at most 2"):
        bisect_mod.node_operand(info, torch.zeros((3, 37), dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="65 live rows"):
        bisect_mod._packed(1, torch.ones((65, 37)), list(range(65)), info)
    # no live row: one plane of zero words (the kernels read word 0 of every node)
    empty = bisect_mod._packed(4, torch.zeros((64, 37)), [], info)
    assert empty.shape == (37 * 5,) and not empty[37 * 4 :].any()
    assert bisect_mod._packed(0, torch.zeros((8, 37)), [], info).shape == (37 * 2,)


def _set(t: np.ndarray, index, value) -> torch.Tensor:
    t = t.copy()
    t[index] = value
    return torch.from_numpy(t)


@pytest.mark.parametrize("case", [
    "labels_0.5", "labels_-1", "sel_2.0", "sel_nan", "pod_f32_live_2.0", "pod_f32_live_inf", "pod_f32_dead_nan",
    "pod_f32_count_column_inf", "node_f32_live_3.0",
])
def test_wrappers_refuse_non_bits_and_non_finite_on_cpu(case):
    """A value other than 0.0 or 1.0 in a live entry of a count operand, or
    a non-finite pod_f32 value anywhere, raises ValueError naming the
    operand, on CPU tensors as on the card."""
    req, sel, selc, ranks, info, labels = _parts_inputs(0)
    pod_i32, pod_f32, winfo, node_f32 = _wide_inputs(0)
    t = torch.from_numpy
    parts = [t(req), t(sel), t(selc), t(ranks.view(np.int32)), t(info), t(labels)]
    wide = [t(pod_i32), t(pod_f32), t(winfo), t(node_f32)]
    operand, where, value = {
        "labels_0.5": ("labels", (3, 7), 0.5), "labels_-1": ("labels", (0, 0), -1.0), "sel_2.0": ("sel", (5, 2), 2.0),
        "sel_nan": ("sel", (1, 1), np.nan), "pod_f32_live_2.0": ("pod_f32", (4, 3), 2.0),
        "pod_f32_live_inf": ("pod_f32", (4, 5), np.inf), "pod_f32_dead_nan": ("pod_f32", (6, 50), np.nan),
        "pod_f32_count_column_inf": ("pod_f32", (6, WIDE_SELC_COL), -np.inf),
        "node_f32_live_3.0": ("node_f32", (1, 11), 3.0),
    }[case]
    if operand in ("labels", "sel"):
        i = 5 if operand == "labels" else 1
        parts[i] = _set(parts[i].numpy(), where, value)
        for variant in (1, 3):
            with pytest.raises(ValueError, match=f"^{operand}: holds"):
                choose_parts(*parts, variant)
        choose_parts(*parts, 0)  # v0 reads neither
    else:
        i = 1 if operand == "pod_f32" else 3
        wide[i] = _set(wide[i].numpy(), where, value)
        with pytest.raises(ValueError, match=f"^{operand}: holds"):
            choose_wide(*wide)


def test_wide_accepts_any_finite_value_in_dead_columns():
    """pod_f32's columns of all-zero node rows may hold any finite value
    (the count column 40 does): the wrapper accepts them and the result is
    the plain version's, the Pallas kernel's too."""
    pod_i32, pod_f32, info, node_f32 = _wide_inputs(3)
    pod_f32[:, 50] = 0.5
    pod_f32[:, 60] = -7.25
    assert not node_f32[[WIDE_SELC_COL, 50, 60]].any() and (pod_f32[:, WIDE_SELC_COL] > 1).any()
    t = torch.from_numpy
    live = bisect_mod.check_count_operands("pod_f32", t(pod_f32), "node_f32", t(node_f32), True)
    assert live == [r for r in range(48) if r != WIDE_SELC_COL]
    _wide_against_pallas(pod_i32, pod_f32, info, node_f32)


def test_jitter_power_of_two_multiply_is_the_division():
    """h · 2^-16, and 1 + h·2^-16 built in the mantissa less 1 (the kernels'
    ``unit16``), equal h / 65536 in float32 bit for bit for every 16-bit h."""
    h = np.arange(1 << 16, dtype=np.uint32)
    want = h.astype(np.float32) / np.float32(65536.0)
    mul = h.astype(np.float32) * np.float32(2.0**-16)
    mantissa = (np.uint32(0x3F800000) | (h << np.uint32(7))).view(np.float32) - np.float32(1.0)
    assert want.dtype == mul.dtype == mantissa.dtype == np.float32
    np.testing.assert_array_equal(mul.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(mantissa.view(np.uint32), want.view(np.uint32))
    ht = torch.from_numpy(h.astype(np.int64))
    assert torch.equal((ht.to(torch.float32) * 2.0**-16).view(torch.int32), (ht.to(torch.float32) / 65536.0).view(torch.int32))


def test_bench_bisect_trees_runs_nothing_when_imported(monkeypatch, capsys):
    """Importing the parent-against-change experiment makes no data and
    prints nothing; without CUDA its main() exits 1 with nothing measured."""
    def refuse(*_a, **_k):
        raise AssertionError("the experiment made data or timed at import")

    mod = importlib.import_module("tpu_scheduler_torch.experiments.bench_bisect_trees")
    monkeypatch.setattr(torch, "randint", refuse)
    monkeypatch.setattr(torch.cuda, "is_available", refuse)
    mod = importlib.reload(mod)
    assert capsys.readouterr().out == ""
    assert not any(isinstance(v, torch.Tensor) for v in vars(mod).values())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main(["parent=build/parent", "change=."]) == 1
    assert capsys.readouterr().out == ""


def test_tile_source_rewrites_the_tile_table_only():
    from tpu_scheduler_torch.experiments.bench_bisect_tiles import tile_source

    src = bisect_mod._SOURCE.read_text()
    out = tile_source(src, 16)
    changed = [(a, b) for a, b in zip(src.splitlines(), out.splitlines()) if a != b]
    assert len(changed) == 1 and changed[0][1] == "constexpr int kTilePods[5] = {16, 16, 16, 16, 16};"
    with pytest.raises(ValueError, match="kTilePods"):
        tile_source("no table here", 8)


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z13choose_kernelILb1ELb1ELb0EEv10ChooseArgs' for 'sm_90a'
ptxas info    : Function properties for _Z13choose_kernelILb1ELb1ELb0EEv10ChooseArgs
    0 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 128 registers, used 0 barriers, 920 bytes cmem[0]
ptxas info    : Compiling entry function '_Z13bisect_kernelILi3ELi2ELi16EEvPKiiPKfiS3_iS1_iPK4int48LiveRowsiiPi' for 'sm_90a'
ptxas info    : Function properties for _Z13bisect_kernelILi3ELi2ELi16EEvPKiiPKfiS3_iS1_iPK4int48LiveRowsiiPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 0 barriers, 652 bytes cmem[0]
ptxas info    : Compiling entry function '_Z6kernelILin4ELb0EEvv' for 'sm_90a'
ptxas info    : Used 8 registers, used 0 barriers
ptxas info    : Compiling entry function 'plain_c_kernel' for 'sm_90a'
ptxas info    : Used 4 registers, used 0 barriers
"""


def test_ptxas_resources_names_bool_and_integer_templates():
    from tpu_scheduler_torch.experiments import ptxas_resources

    got = ptxas_resources(PTXAS_LOG)
    assert got == {
        "choose_kernel<true,true,false>": {"spill_stores": 12, "spill_loads": 16, "registers": 128},
        "bisect_kernel<3,2,16>": {"spill_stores": 0, "spill_loads": 0, "registers": 90},
        "kernel<-4,false>": {"registers": 8},
        "plain_c_kernel": {"registers": 4},
    }


SASS_LISTING = """\
\t\tFunction : _Z13bisect_kernelILi0ELi1ELi4EEvPKiiPKfiS3_iS1_iS1_8LiveRowsiiPi
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
        /*0010*/                   LDG.E.64.CONSTANT R2, desc[UR4][R4.64] ;  /* 0x0000000404027981 */
        /*0020*/                   ISETP.GT.AND P1, PT, R25, R2, PT ;      /* 0x000000021900720c */
        /*0030*/                   ISETP.LE.AND P1, PT, R26, R3, !P1 ;     /* 0x000000031a00720c */
        /*0040*/                   FSEL R6, RZ, 1, !P1 ;                   /* 0x3f800000ff067808 */
        /*0050*/              @!P0 BRA 0x10 ;                              /* 0xfffffffc00208947 */
        /*0060*/                   EXIT ;                                  /* 0x000000000000794d */
\t\tFunction : _Z12other_kernelv
        /*0000*/                   EXIT ;                                  /* 0x000000000000794d */
"""


def test_pod_loop_counts_reads_the_loop_of_each_instance():
    """The SASS counter takes the span a backward branch closes as the pod
    loop and divides by the pairs a pass scores (capacity loads × pods)."""
    from tpu_scheduler_torch.experiments.bisect_sass import pod_loop_counts

    got = pod_loop_counts(SASS_LISTING)
    assert list(got) == ["bisect_kernel<0,1,4>"]
    rec = got["bisect_kernel<0,1,4>"]
    assert rec["nodes_per_pass"] == 1 and rec["per_pair"] == 5 / 4
    assert rec["opcodes"] == {"ISETP": 0.5, "LDG": 0.25, "FSEL": 0.25, "BRA": 0.25}
