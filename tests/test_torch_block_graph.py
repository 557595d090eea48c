"""The port's block graphs and its ``double_buffer`` ring.

On the CPU (the step pipeline's plain path):
* ``capture="block"`` needs a CUDA device and raises on the CPU; an
  unknown mode raises; the CPU default issues eagerly;
* each ledger slot of the ring gets a signal-word set of its own, of the
  right size, and ``off`` gets one;
* under a wire format the ring holds ``wire_encode_ext``'s parts and
  drains them through ``wire_decode_ext`` / ``rev_local_raw``, and its
  ``int8_ef`` residual equals serial mode's step for step, bitwise;
* the ring's ledger is the reference's transitions, in its order.

On the CPU also: every MD kernel's launch counter is matched to its
kernel's name (by which a captured graph's nodes are counted), and a
step's inputs flatten to tensors and rebuild.

On the card (``-m cuda``): a 2x2x2 system run for five blocks with
``capture="block"`` against ``capture="off"``, per MD path: state,
forces, per-step metrics, diagnostics, ledgers and launch counters
bitwise equal, with step graphs replayed.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.halo_plan import HaloPlan, HaloSpec
from repro_torch.core.md import MDEngine, make_grappa_like
from repro_torch.core.pipeline import SignalLedger, StepFns, StepPipeline
from repro_torch.core.pipeline.block_graph import (
    KERNEL_COUNTERS,
    KERNEL_NODES,
    BlockGraphs,
    _build,
    _flatten,
    _kernel_ident,
)
from repro_torch.core.md import pair_schedule
from repro_torch.kernels import nonbonded
from repro_torch.launch.mesh import make_mesh
from _torch_threads import share_cores

AXES = ("z", "y", "x")


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """Run this module's PyTorch ops on the worker's share of the cores."""
    yield from share_cores()


def _toy_fns():
    """The reference's toy physics on block tensors (``aux`` is each
    domain's own sum), its metrics reduced by ``reduce``."""
    def begin(state, f, ctx):
        state = state + 0.1 * f
        return state, state.sum(dim=(1, 2), keepdim=True), state

    def force(ext, ctx):
        F = torch.tanh(ext) * ctx
        return F, {"pe": F}

    def finish(state, aux, f, ctx):
        state = state + 0.01 * f + 1e-3 * aux
        return state, f, {"ke": state}

    def reduce(raw):
        return {k: torch.sum(v) for k, v in raw.items()}

    return StepFns(begin=begin, force=force, finish=finish, reduce=reduce)


def _pipe(mode, depth, n_dom=3, backend="signal", wire_dtype=None,
          widths=(1,), pulses=None):
    plan = HaloPlan.build(HaloSpec(("z",), widths, backend=backend,
                                   wire_dtype=wire_dtype, pulses=pulses),
                          make_mesh((n_dom,), ("z",)), device="cpu")
    return StepPipeline.build(plan, _toy_fns(), mode=mode, depth=depth)


def _x0(n_dom, dtype=np.float32):
    x = np.random.RandomState(0).randn(n_dom * 6, 4).reshape(n_dom, 6, 4)
    return torch.from_numpy(x.astype(dtype))


def _run(pipe, n_steps, dtype=np.float32):
    x0 = _x0(pipe.plan.axis_sizes[0], dtype)
    return pipe.run_local(x0, torch.zeros_like(x0), n_steps,
                          torch.tensor(0.5, dtype=x0.dtype))


# --------------------------------------------------------------------------
# capture modes
# --------------------------------------------------------------------------

def test_capture_modes_on_the_cpu():
    s = make_grappa_like(300, seed=11)
    mesh = make_mesh((1, 1, 1), AXES)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        MDEngine(s, mesh, device="cpu", capture="block")
    with pytest.raises(ValueError, match="unknown capture mode"):
        MDEngine(s, mesh, device="cpu", capture="step")
    eng = MDEngine(s, mesh, device="cpu")
    assert eng.capture == "off" and eng.block_graphs is None
    with pytest.raises(ValueError, match="need a CUDA device"):
        BlockGraphs(torch.device("cpu"))


def test_block_graph_counters_cover_every_md_kernel():
    """Every MD kernel wrapper's counters are kept true across replays:
    each launch counter has its kernel's name, by which a captured
    graph's nodes are counted; ``inverse_builds`` (PyTorch work) has
    none, and a capture must leave it unmoved."""
    from repro_torch.kernels import halo_pack, nonbonded
    held = {(getattr(o, "__name__", o), a) for o, a in KERNEL_COUNTERS}
    for fn in (halo_pack.pack, halo_pack.unpack_add, halo_pack.put_signal,
               halo_pack.fused_pulses, nonbonded.pair_forces,
               nonbonded.scatter_accum):
        for attr in ("launches", "wire_launches", "inverse_builds"):
            if hasattr(fn, attr):
                assert (fn.__name__, attr) in held
    named = set(KERNEL_NODES.values())
    assert set(KERNEL_COUNTERS) - named == {
        (halo_pack.unpack_add, "inverse_builds")}
    sources = "".join(
        (Path(__file__).parents[1] / "src" / "repro_torch" / "csrc" / f
         ).read_text() for f in ("halo_pack.cu", "halo_signal.cu",
                                 "nonbonded.cu"))
    for ident in KERNEL_NODES:
        assert re.search(rf"\b{ident}\b\(", sources), ident


@pytest.mark.parametrize("name,ident", [
    ("_ZN12_GLOBAL__N_111pack_kernelIjEEvPKT_PKiPS1_iiii", "pack_kernel"),
    ("_ZN12_GLOBAL__N_119pack_convert_kernelIdfLi4EEEvPK5LanesIT_XT1_EEPKiP"
     "T0_iiii", "pack_convert_kernel"),
    ("_ZN12_GLOBAL__N_117unpack_add_kernelIfLi4EEEvPK5LanesIT_XT0_EE",
     "unpack_add_kernel"),
    ("_ZN12_GLOBAL__N_117put_signal_kernelI4uint4EEvPKT_", "put_signal_kernel"),
    ("_ZN12_GLOBAL__N_125put_signal_convert_kernelIdfLi4EEEvv",
     "put_signal_convert_kernel"),
    ("_ZN12_GLOBAL__N_119fused_pulses_kernelIjEEvPKT_", "fused_pulses_kernel"),
    ("_ZN12_GLOBAL__N_118pair_forces_kernelIfLi4EEEvPKT_",
     "pair_forces_kernel"),
    ("_ZN12_GLOBAL__N_120scatter_accum_kernelI6float4EEvPKi",
     "scatter_accum_kernel"),
    ("void (anonymous namespace)::unpack_add_kernel<float, 4>(...)",
     "unpack_add_kernel"),
    ("void (anonymous namespace)::pack_kernel<unsigned int>(...)",
     "pack_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::FillFunctor<float>>(int, ...)", None),
    ("_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11FillFunctorIfEE"
     "EEviT0_T1_", None),
])
def test_kernel_nodes_are_named_by_their_kernel(name, ident):
    """A graph's kernel node is matched to its wrapper's counter by the
    kernel's name, mangled or not; PyTorch's own kernels match none."""
    assert _kernel_ident(name) == ident


def test_graph_inputs_flatten_and_rebuild():
    """A step's inputs and context (tensors in tuples, dicts, named
    tuples and dataclasses, with ints and None) flatten to their tensors
    and a hashable structure, and rebuild unchanged."""
    idx = nonbonded.ScatterIndex(torch.arange(4), torch.arange(3))
    tb = pair_schedule.TierBatch(
        k=8, cell_a=torch.ones(2), cell_b=torch.zeros(2), same=torch.ones(2),
        cnt_a=torch.ones(2), cnt_b=torch.ones(2), ta=torch.ones(2, 8),
        tb=torch.ones(2, 8), index=idx)
    x = (torch.ones(3), None, (torch.zeros(2), torch.ones(1)),
         {"cell_i": torch.ones(2, 2), "batches": (tb,)})
    leaves = []
    sig = _flatten(x, leaves)
    hash(sig)
    assert len(leaves) == 4 + 7 + 2 and all(
        isinstance(t, torch.Tensor) for t in leaves)
    y = _build(sig, iter(leaves))
    assert y[1] is None and y[3]["batches"][0].k == 8
    assert type(y[3]["batches"][0].index) is nonbonded.ScatterIndex
    again = []
    assert _flatten(y, again) == sig
    assert all(a is b for a, b in zip(leaves, again))


# --------------------------------------------------------------------------
# the ring
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode,depth", [("off", 2), ("double_buffer", 2),
                                        ("double_buffer", 3),
                                        ("double_buffer", 4)])
@pytest.mark.parametrize("pulses", [None, (2,)], ids=["p1", "p2"])
def test_signal_words_one_set_per_ledger_slot(mode, depth, pulses):
    """Step k's launches use ledger slot k % depth's words: a double
    buffered run allocates ``depth`` sets, ``off`` one; each set holds
    put_signal's 2 x n_dom words and, with several pulses, fused_pulses'
    2 x n_dom x P + 1, and no two sets overlap."""
    widths = (2,) if pulses else (1,)
    pipe = _pipe(mode, depth, n_dom=3, widths=widths, pulses=pulses)
    _run(pipe, 7)
    sets = {k[1]: v for k, v in pipe.plan._index_maps.items()
            if isinstance(k, tuple) and k[:1] == ("signal_words",)}
    assert sorted(sets) == list(range(pipe.depth))
    assert pipe.depth == (depth if mode == "double_buffer" else 1)
    spans = []
    for put, fused in sets.values():
        assert put.numel() == 2 * 3
        assert fused.numel() == (2 * 3 * 2 + 1 if pulses else 0)
        spans.append((put.data_ptr(), put.data_ptr() + 4 * (
            put.numel() + fused.numel())))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


def _recording(plan, names):
    """Wrap plan methods to record each call's arguments and result."""
    calls = {n: [] for n in names}
    for n in names:
        fn = getattr(plan, n)

        def rec(*a, _fn=fn, _n=n, **k):
            out = _fn(*a, **k)
            calls[_n].append((a, k, out))
            return out
        setattr(plan, n, rec)
    return calls


@pytest.mark.parametrize("depth", [2, 3, 4])
@pytest.mark.parametrize("wire_dtype", ["float32", "bfloat16", "int8_ef"])
def test_ring_holds_wire_parts_and_the_residual_matches_serial(wire_dtype,
                                                               depth):
    """Under a wire format ``double_buffer`` fills each slot with
    ``wire_encode_ext``'s parts and drains them through
    ``wire_decode_ext`` + ``rev_local_raw`` (``off`` never does); the
    int8_ef residual after each step's fill equals serial mode's after
    each step's ``rev_local_ef``, bitwise; and the runs are equal."""
    n_steps = 6
    ser = _pipe("off", 2, backend="pallas", wire_dtype=wire_dtype)
    db = _pipe("double_buffer", depth, backend="pallas",
               wire_dtype=wire_dtype)
    c_ser = _recording(ser.plan, ("wire_encode_ext", "rev_local_ef",
                                  "rev_local", "rev_local_raw"))
    c_db = _recording(db.plan, ("wire_encode_ext", "wire_decode_ext",
                                "rev_local_raw", "rev_local_ef",
                                "rev_local"))
    got = _run(db, n_steps, np.float64)
    want = _run(ser, n_steps, np.float64)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for k in want[2]:
        assert torch.equal(got[2][k], want[2][k]), k
    assert not c_ser["wire_encode_ext"] and not c_ser["rev_local_raw"]
    assert len(c_db["wire_encode_ext"]) == n_steps
    assert len(c_db["wire_decode_ext"]) == len(c_db["rev_local_raw"]) \
        == n_steps
    assert not c_db["rev_local"] and not c_db["rev_local_ef"]
    # the drains read the slots in step order: slot k % depth
    assert [c[1]["slot"] for c in c_db["rev_local_raw"]] == \
        [k % depth for k in range(n_steps)]
    for (_a, _k, (parts, _ef)) in c_db["wire_encode_ext"]:
        wire_part = parts[0]
        assert wire_part.dtype == {"float32": torch.float32,
                                   "bfloat16": torch.bfloat16,
                                   "int8_ef": torch.int8}[wire_dtype]
        assert parts[-1].dtype == torch.float64     # the exact body
    if wire_dtype == "int8_ef":
        assert len(c_ser["rev_local_ef"]) == n_steps
        for (_a, _k, (_p, ef_db)), (_a2, _k2, (_f, ef_ser)) in zip(
                c_db["wire_encode_ext"], c_ser["rev_local_ef"]):
            assert torch.equal(ef_db, ef_ser)
    else:
        assert len(c_ser["rev_local"]) == n_steps


def _reference_order(led: SignalLedger, n_steps: int):
    """The reference's ``_run_pipelined`` ledger transitions in order."""
    seq = [("release", "fwd", 0), ("acquire", "fwd", 0),
           ("release", "rev", 0)]
    for k in range(1, n_steps):
        seq += [("acquire", "rev", k - 1), ("release", "fwd", k),
                ("acquire", "fwd", k), ("release", "rev", k)]
    seq.append(("acquire", "rev", n_steps - 1))
    return [(op, kind, buf % led.depth) for op, kind, buf in seq]


@pytest.mark.parametrize("n_steps", [1, 2, 5, 8])
@pytest.mark.parametrize("depth", [2, 3, 4])
def test_ring_ledger_transitions_in_the_reference_order(depth, n_steps):
    pipe = _pipe("double_buffer", depth)
    seen = []
    ledger = pipe.ledger

    class Spy:
        depth = ledger.depth
        n_pulses = ledger.n_pulses

        def init(self):
            return ledger.init()

        def release(self, st, kind, buf):
            seen.append(("release", kind, buf))
            return ledger.release(st, kind, buf)

        def acquire(self, st, kind, buf):
            seen.append(("acquire", kind, buf))
            return ledger.acquire(st, kind, buf)

    pipe.ledger = Spy()
    *_, led = _run(pipe, n_steps)
    assert seen == _reference_order(ledger, n_steps)
    assert ledger.drained(led) and ledger.window_safe(led)
    assert ledger.in_flight(led) == 0


# --------------------------------------------------------------------------
# on the card: captured blocks against eager issue
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _counters():
    return tuple(getattr(o, a) for o, a in KERNEL_COUNTERS) + (
        pair_schedule.roll_prune.calls,)


def _drive(eng, n_steps):
    """``simulate``'s block loop, keeping each block's metrics, force
    carry, ledger and the launch counters it moved."""
    nst = eng.system.params.nstlist
    rs = eng.begin_run()
    blocks = []
    while rs.step < n_steps:
        take = min(nst, n_steps - rs.step)
        fuse = eng.overlap_rebin and rs.step + take < n_steps
        c0 = _counters()
        m = eng.run_block(rs, take, fuse=fuse)
        torch.cuda.synchronize()
        moved = tuple(b - a for a, b in zip(c0, _counters()))
        blocks.append(({k: v.clone() for k, v in m.items()},
                       rs.force.clone(), rs.ledger, moved))
        if not fuse and rs.step < n_steps:
            eng.advance_schedule(rs)
    return rs, blocks


CELLS = {
    "dense-pallas": (np.float32, dict(spec=dict(backend="pallas"))),
    "pruned-pallas": (np.float32, dict(spec=dict(backend="pallas"),
                                       force_backend="pallas")),
    "pruned-pallas-nstprune5": (np.float32, dict(
        spec=dict(backend="pallas"), force_backend="pallas", nstprune=5)),
    "signal-db2-ovr": (np.float32, dict(
        spec=dict(backend="signal"), pipeline="double_buffer",
        overlap_rebin=True)),
    "signal-db3-pruned": (np.float32, dict(
        spec=dict(backend="signal"), pipeline="double_buffer",
        pipeline_depth=3, force_backend="pallas", nstprune=5)),
    "signal-db4-w2p2": (np.float32, dict(
        spec=dict(backend="signal", widths=(2, 2, 2), pulses=(2, 2, 2)),
        pipeline="double_buffer", pipeline_depth=4)),
    "f64-float32-pallas": (np.float64, dict(
        spec=dict(backend="pallas"), force_backend="pallas",
        wire_dtype="float32")),
    "f64-int8_ef-signal-db2": (np.float64, dict(
        spec=dict(backend="signal"), force_backend="pallas",
        pipeline="double_buffer", wire_dtype="int8_ef")),
    "f64-bfloat16-dense-db3": (np.float64, dict(
        spec=dict(backend="pallas"), pipeline="double_buffer",
        pipeline_depth=3, wire_dtype="bfloat16")),
}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(CELLS))
def test_cuda_block_graphs_match_eager_issue(cuda_device, cell):
    dtype, kw = CELLS[cell]
    kw = dict(kw)
    spec = {"widths": (1, 1, 1), **kw.pop("spec")}
    s = make_grappa_like(1600, seed=3, dtype=dtype, nstlist=10)
    mesh = make_mesh((2, 2, 2), AXES)
    runs = {}
    for capture in ("off", "block"):
        eng = MDEngine(s, mesh, HaloSpec(AXES, **spec), device="cuda",
                       capture=capture, **kw)
        runs[capture] = (eng, *_drive(eng, 50))
    (e_off, rs_off, b_off), (e_blk, rs_blk, b_blk) = runs["off"], \
        runs["block"]
    assert torch.equal(rs_off.cell_f, rs_blk.cell_f)
    assert torch.equal(rs_off.cell_i, rs_blk.cell_i)
    assert torch.equal(rs_off.force, rs_blk.force)
    assert rs_off.diags == rs_blk.diags and len(rs_blk.diags) == 5
    assert e_off.sched_history == e_blk.sched_history
    for (m0, f0, l0, c0), (m1, f1, l1, c1) in zip(b_off, b_blk):
        assert sorted(m0) == sorted(m1) == ["ke", "mom", "pe"]
        for k in m0:
            assert torch.equal(m0[k], m1[k]), k
        assert torch.equal(f0, f1)
        for a, b in zip(l0, l1):
            assert np.array_equal(a, b)
        assert c0 == c1 and sum(c1) > 0
    st = e_blk.block_graphs.stats()
    # a step unit's first two calls of a key run eagerly, the third
    # captures: replayed steps in every cell, pruned ones (a new tier
    # ladder each block) within each block
    steps = sum(v for k, v in st["replays_by_kind"].items()
                if k == "step" or k.startswith("unit"))
    assert steps >= 5, st
    assert st["replays"] >= st["captures"] >= 1
    assert e_off.block_graphs is None
