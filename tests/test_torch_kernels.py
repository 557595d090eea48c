"""Port's halo kernels against the JAX Pallas kernels, bitwise.

The JAX side runs its kernels in interpret mode on the CPU; the port's
oracles (``kernels/ref.py``) and its wrappers' plain forms (which CPU
tensors take) must give identical bits for f32, f64 and int32.
``put_signal`` and ``fused_pulses`` put to ring neighbours, so their JAX
side runs on a 4-device ring in one session subprocess (as
``tests/dist/check_kernel_halo.py`` does).  The ``cuda`` cases hold the
CUDA kernels against the plain forms on the card and skip without one.
"""
import contextlib
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import halo_pack, ref
from _torch_threads import share_cores

DTYPES = [np.float32, np.float64, np.int32]
SHAPES = [(64, 32, 4), (100, 60, 7), (16, 128, 3)]
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """Run this module's PyTorch ops on the worker's share of the cores."""
    yield from share_cores()


class JaxKernels:
    """The reference's Pallas kernels in interpret mode (imported only
    where JAX is installed: the card's machine runs the ``cuda`` cases
    without it)."""

    def __init__(self):
        import jax
        import jax.numpy as jnp
        from repro.kernels import halo_pack as jax_halo_pack
        self.jax, self.jnp, self.hp = jax, jnp, jax_halo_pack

    @contextlib.contextmanager
    def x64(self, enabled: bool):
        old = self.jax.config.jax_enable_x64
        self.jax.config.update("jax_enable_x64", enabled)
        try:
            yield
        finally:
            self.jax.config.update("jax_enable_x64", old)

    def pack(self, src, idx):
        with self.x64(src.dtype == np.float64):
            return np.asarray(self.hp.pack(self.jnp.asarray(src),
                                           self.jnp.asarray(idx),
                                           interpret=True))

    def unpack_add(self, dst, idx, rows):
        with self.x64(dst.dtype == np.float64):
            return np.asarray(self.hp.unpack_add(
                self.jnp.asarray(dst), self.jnp.asarray(idx),
                self.jnp.asarray(rows), interpret=True))


@pytest.fixture(scope="module")
def jk():
    pytest.importorskip("jax")
    return JaxKernels()


def _src(rng, shape, dtype):
    if dtype == np.int32:
        return rng.randint(-1000, 1000, size=shape).astype(dtype)
    return rng.randn(*shape).astype(dtype)


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


# ---- pack ------------------------------------------------------------------

@pytest.mark.parametrize("p,m,f", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_pack_ref_matches_jax_bitwise(jk, p, m, f, dtype):
    rng = np.random.RandomState(p + m)
    src = _src(rng, (p, f), dtype)
    idx = rng.randint(0, p, size=(m,)).astype(np.int32)
    idx[::5] = -1                                          # padding rows
    want = jk.pack(src, idx)
    got = ref.pack_ref(torch.from_numpy(src), torch.from_numpy(idx))
    assert _bits_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pack_batched_cpu_matches_jax_bitwise(jk, dtype):
    """n_dom=8 blocks, one shared map: each domain equals the JAX kernel."""
    rng = np.random.RandomState(7)
    src = _src(rng, (8, 50, 6), dtype)
    idx = rng.randint(0, 50, size=(24,)).astype(np.int32)
    idx[::5] = -1
    got = halo_pack.pack(torch.from_numpy(src), torch.from_numpy(idx))
    assert got.shape == (8, 24, 6)
    for b in range(8):
        assert _bits_equal(got[b].numpy(), jk.pack(src[b], idx))


# ---- unpack_add --------------------------------------------------------------

@pytest.mark.parametrize("p,m,f", [(64, 32, 4), (100, 60, 7), (128, 16, 3)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_unpack_add_ref_matches_jax_bitwise(jk, p, m, f, dtype):
    rng = np.random.RandomState(p * m)
    dst = _src(rng, (p, f), dtype)
    rows = _src(rng, (m, f), dtype)
    idx = rng.permutation(p)[:m].astype(np.int32)          # unique, >= 0
    want = jk.unpack_add(dst, idx, rows)
    got = ref.unpack_add_ref(torch.from_numpy(dst), torch.from_numpy(idx),
                             torch.from_numpy(rows))
    assert _bits_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype,inverse", [
    *(pytest.param(dt, False, id=dt.__name__) for dt in DTYPES),
    *(pytest.param(dt, True, id=f"{dt.__name__}-inverse") for dt in DTYPES)])
def test_unpack_add_batched_cpu_matches_jax_bitwise(jk, dtype, inverse):
    """With ``inverse`` (what the kernel reads on the card) the CPU path
    checks it against the map and runs the same plain form."""
    rng = np.random.RandomState(11)
    dst = _src(rng, (8, 40, 5), dtype)
    rows = _src(rng, (8, 12, 5), dtype)
    idx = rng.permutation(40)[:12].astype(np.int32)
    inv = halo_pack.inverse_map(torch.from_numpy(idx), 40) if inverse \
        else None
    got = halo_pack.unpack_add(torch.from_numpy(dst), torch.from_numpy(idx),
                               torch.from_numpy(rows), inv)
    for b in range(8):
        assert _bits_equal(got[b].numpy(),
                           jk.unpack_add(dst[b], idx, rows[b]))


def _brute_inverse(index_map, R):
    inv = [-1] * R
    for m, r in enumerate(index_map.tolist()):
        inv[r] = m
    return inv


@pytest.mark.parametrize("widths,pulses", [((1, 1, 1), None),
                                           ((2, 2, 2), (2, 2, 2))])
@pytest.mark.parametrize("mesh_shape", [(2, 2, 2), (3, 2, 1), (1, 1, 1)])
def test_inverse_map_matches_brute_force(mesh_shape, widths, pulses):
    """Every reverse pulse's inverse that the pallas backend builds is the
    brute-force inverse of its add map over the pulse's body rows."""
    from repro_torch import HaloPlan, HaloSpec, make_mesh
    axes = ("z", "y", "x")
    local = (4, 3, 5)
    plan = HaloPlan.build(HaloSpec(axes, widths, backend="pallas",
                                   pulses=pulses),
                          make_mesh(mesh_shape, axes), device="cpu")
    _, rev_maps = plan.backend._maps(plan, local)
    shape = [n + w for n, w in zip(local, widths)]
    order = list(reversed(plan.sched.serialized_order()))
    assert len(rev_maps) == len(order) and all(m is not None for m in rev_maps)
    for pulse, maps in zip(order, rev_maps):
        d = pulse.dim
        shape[d] -= pulse.width
        R = int(np.prod(shape[:d + 1]))
        assert maps.add_inv.dtype == torch.int32
        assert maps.add_inv.tolist() == _brute_inverse(maps.add_idx, R)
        assert torch.equal(halo_pack.inverse_map(maps.add_idx, R),
                           maps.add_inv)
    assert shape == list(local)


def test_inverse_map_refuses_repeated_and_outside_rows(monkeypatch):
    with pytest.raises(ValueError, match="more than once"):
        halo_pack.inverse_map(torch.tensor([0, 2, 2], dtype=torch.int32), 4)
    for bad in ([0, 4], [-1, 1]):
        with pytest.raises(IndexError, match="outside"):
            halo_pack.inverse_map(torch.tensor(bad, dtype=torch.int32), 4)
    assert halo_pack.inverse_map(torch.tensor([], dtype=torch.int32),
                                 3).tolist() == [-1, -1, -1]
    # a repeated row in a plan's map raises where the plan builds it
    from repro_torch import HaloPlan, HaloSpec, make_mesh
    from repro_torch.core import halo_plan
    good = halo_plan.PallasBackend._rows_along
    monkeypatch.setattr(halo_plan.PallasBackend, "_rows_along", staticmethod(
        lambda shape, d, lo, hi: np.concatenate(
            [good(shape, d, lo, hi)] * 2)))
    plan = HaloPlan.build(HaloSpec(("z", "y", "x"), (1, 1, 1),
                                   backend="pallas"),
                          make_mesh((1, 1, 1), ("z", "y", "x")), device="cpu")
    with pytest.raises(ValueError, match="more than once"):
        plan.fwd(torch.zeros((1, 1, 1, 4, 3, 5, 2)))


def test_unpack_add_refuses_an_inverse_of_another_map():
    """On the card the kernel reads only the inverse, so the CPU path holds
    a given inverse to the map: one built for another map of the same R
    (a stale cache entry, say) raises rather than add into other rows."""
    dst = torch.zeros((2, 6, 3))
    rows = torch.ones((2, 2, 3))
    idx = torch.tensor([1, 4], dtype=torch.int32)
    stale = halo_pack.inverse_map(torch.tensor([4, 1], dtype=torch.int32), 6)
    with pytest.raises(ValueError, match="is not inverse_map"):
        halo_pack.unpack_add(dst, idx, rows, stale)
    out = halo_pack.unpack_add(dst, idx, rows, halo_pack.inverse_map(idx, 6))
    assert out[:, [1, 4]].eq(1).all() and out[:, [0, 2, 3, 5]].eq(0).all()


def test_wrappers_validate_inputs():
    src = torch.zeros((2, 5, 3))
    idx = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        halo_pack.pack(src, idx.long())
    with pytest.raises(ValueError, match="3-D"):
        halo_pack.pack(src[0], idx)
    with pytest.raises(ValueError, match="contiguous"):
        halo_pack.pack(src.transpose(1, 2), idx)
    with pytest.raises(TypeError, match="not supported"):
        halo_pack.pack(src.half(), idx)
    with pytest.raises(ValueError, match="rows shape"):
        halo_pack.unpack_add(src, idx, torch.zeros((2, 3, 3)))
    rows = torch.zeros((2, 4, 3))
    inv = halo_pack.inverse_map(torch.tensor([0, 1, 2, 3],
                                             dtype=torch.int32), 5)
    with pytest.raises(ValueError, match="inverse holds 4 rows"):
        halo_pack.unpack_add(src, idx, rows, inv[:4])
    with pytest.raises(TypeError, match="int32"):
        halo_pack.unpack_add(src, idx, rows, inv.long())
    with pytest.raises(ValueError, match="1-D"):
        halo_pack.unpack_add(src, idx, rows, inv[None])


@pytest.mark.parametrize("kernel", ["pack", "unpack_add"])
def test_plain_forms_reject_indices_outside_the_block(kernel):
    """An index past the block (or, for unpack_add, below 0) raises in the
    plain form; on the card the same map traps the kernel."""
    src = torch.zeros((2, 5, 3))
    for bad in ([0, 5], [-1, 2]) if kernel == "unpack_add" else ([0, 5],):
        idx = torch.tensor(bad, dtype=torch.int32)
        with pytest.raises((IndexError, RuntimeError),
                           match="(?i)ind(ex|ices)"):
            if kernel == "pack":
                halo_pack.pack(src, idx)
            else:
                halo_pack.unpack_add(src, idx, torch.ones((2, 2, 3)))


def test_cpu_path_launches_no_kernel():
    kernels = (halo_pack.pack, halo_pack.unpack_add, halo_pack.put_signal,
               halo_pack.fused_pulses)
    before = [k.launches for k in kernels]
    src = torch.ones((2, 5, 3))
    idx = torch.tensor([0, 2], dtype=torch.int32)
    halo_pack.unpack_add(src, idx, halo_pack.pack(src, idx))
    halo_pack.put_signal(src, idx, (2,), 0, -1)
    halo_pack.fused_pulses(src, torch.tensor([[0, 2], [5, 6]], dtype=torch.int32),
                           5, (2, 1), 0)
    assert [k.launches for k in kernels] == before


# ---- put_signal / fused_pulses against JAX on a 4-device ring --------------

RING, N_LOCAL, RING_F = 4, 6, 3
PUT_MAPS = {"plain": [0, 1, 4], "padded": [-1, 5, 2, -1, 0]}
# one wide row (M = 1), the forward z pulse's kind: on the card the flat
# grid splits it over several blocks
WIDE_ROWS, WIDE_F, WIDE_MAP = 2, 7840, [1]
# (n_pulses, M) maps: entries >= N_LOCAL forward rows of the previous
# pulse's receive buffer; "dep2" is the map of check_kernel_halo.py (on the
# card's flat grid, 3x2 domains and F = 40 f32, pulse 0 is 240 words and
# the first block of 256 would run into pulse 1's forwarded row 1 were
# pulses not padded to whole blocks); "dep3w" has 300 words a pulse there
# (two blocks, the second part-filled) and forwards in the first rows of
# pulses 1 and 2, one of them a padding row
FUSED_MAPS = {
    "indep": [[0, 1, 2, 3], [5, 4, 3, 2]],
    "dep2": [[0, 1, 2, 3], [4, N_LOCAL + 1, N_LOCAL + 3, -1]],
    "dep3": [[5, 0, -1], [N_LOCAL + 0, 2, N_LOCAL + 1],
             [N_LOCAL + 2, N_LOCAL + 0, 3]],
    "dep3w": [[0, 5, 2, -1, 4], [N_LOCAL + 1, 1, N_LOCAL + 0, 3, -1],
              [N_LOCAL + 4, N_LOCAL + 0, 0, -1, N_LOCAL + 2]],
}

_JAX_RING_SCRIPT = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map_norep
from repro.kernels import halo_pack
from repro.launch.mesh import make_mesh
put_maps, fused_maps = eval(sys.argv[2]), eval(sys.argv[3])
wide_rows, wide_f, wide_map = eval(sys.argv[4])
RING, N_LOCAL, F = 4, 6, 3
# an int32 ring size: under x64 a Python int would make the kernels'
# lax.rem(int32 axis index, int64) refuse to trace
ring = np.int32(RING)
assert len(jax.devices()) >= RING
mesh = make_mesh((RING,), ("z",))
out = {}
for dt in ("float32", "float64"):
    x = np.random.RandomState(0).randn(RING * N_LOCAL, F).astype(dt)
    out["x_" + dt] = x
    def run(body):
        fn = shard_map_norep(body, mesh=mesh, in_specs=(P("z"),),
                             out_specs=P("z"))
        return np.asarray(jax.jit(fn)(jnp.asarray(x)))
    for name, m in put_maps.items():
        for shift in (-1, 1):
            idx = jnp.asarray(m, dtype=jnp.int32)
            out[f"put_{name}_{shift}_{dt}"] = run(
                lambda lo: halo_pack.put_signal(lo, idx, axis="z", ring=ring,
                                                shift=np.int32(shift)))
    for name, m in fused_maps.items():
        maps = jnp.asarray(np.asarray(m, np.int32))
        out[f"fused_{name}_{dt}"] = run(
            lambda lo: halo_pack.fused_pulses(lo, maps, axis="z", ring=ring,
                                              n_local=N_LOCAL))
    # the wire forms, on values at and beside the wire grids' ties
    k = np.arange(RING * N_LOCAL * F, dtype=np.float64)
    xw = ((1 + (k % 1024) / 1024 + 2.0 ** -11 + (-1) ** k * 2.0 ** -40)
          * 2.0 ** (k % 13 - 6) * (-1) ** (k // 2)).astype(dt)
    xw = xw.reshape(RING * N_LOCAL, F)
    out["xw_" + dt] = x = xw
    wires = ("bfloat16", "float16") + (("float32",) if dt == "float64"
                                       else ())
    for wire in wires:
        for shift in (-1, 1):
            idx = jnp.asarray(put_maps["padded"], dtype=jnp.int32)
            out[f"putw_{shift}_{dt}_{wire}"] = run(
                lambda lo: halo_pack.put_signal(
                    lo, idx, axis="z", ring=ring, shift=np.int32(shift),
                    wire_dtype=wire)).view(np.uint16 if wire != "float32"
                                           else np.uint32)
# one wide row, both shifts: the f32 bit copy, and f64 -> f32 on values at
# and beside f32's ties
idx = jnp.asarray(wide_map, dtype=jnp.int32)
k = np.arange(RING * wide_rows * wide_f, dtype=np.float64)
x = np.random.RandomState(1).randn(RING * wide_rows, wide_f)
out["wide_x"] = x = x.astype(np.float32)
for shift in (-1, 1):
    out[f"wide_{shift}"] = run(
        lambda lo: halo_pack.put_signal(lo, idx, axis="z", ring=ring,
                                        shift=np.int32(shift)))
x = ((1 + (k % 2 ** 20) * 2.0 ** -23 + 2.0 ** -24
      + (k % 3 - 1) * 2.0 ** -45) * 2.0 ** (k % 13 - 6) * (-1) ** (k // 2))
out["wide_xw"] = x = x.reshape(RING * wide_rows, wide_f)
for shift in (-1, 1):
    out[f"widew_{shift}"] = run(
        lambda lo: halo_pack.put_signal(
            lo, idx, axis="z", ring=ring, shift=np.int32(shift),
            wire_dtype="float32")).view(np.uint32)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="session")
def jax_ring(tmp_path_factory):
    """JAX's put_signal (both shifts) and fused_pulses in interpret mode on
    a 4-device ring, f32 and f64: one subprocess for the session."""
    pytest.importorskip("jax")
    out = tmp_path_factory.mktemp("jax_ring") / "ring.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={RING}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = f"{REPO / 'src'}:{env.get('PYTHONPATH', '')}"
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_RING_SCRIPT, str(out), repr(PUT_MAPS),
         repr(FUSED_MAPS), repr((WIDE_ROWS, WIDE_F, WIDE_MAP))],
        capture_output=True, text=True, timeout=600,
        env=env)
    if proc.returncode != 0:
        raise AssertionError(f"JAX ring reference failed:\n{proc.stderr}")
    return dict(np.load(out))


@pytest.mark.parametrize("shift", [-1, 1])
@pytest.mark.parametrize("name", list(PUT_MAPS))
@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_put_signal_plain_matches_jax_ring_bitwise(jax_ring, dt, name, shift):
    x = torch.from_numpy(jax_ring[f"x_{dt}"]).reshape(RING, N_LOCAL, RING_F)
    idx = torch.tensor(PUT_MAPS[name], dtype=torch.int32)
    got = halo_pack.put_signal(x, idx, (RING,), 0, shift)
    want = jax_ring[f"put_{name}_{shift}_{dt}"].reshape(RING, len(idx),
                                                         RING_F)
    assert _bits_equal(got.numpy(), want)
    assert _bits_equal(halo_pack.put_signal_plain(x, idx, (RING,), 0,
                                                  shift).numpy(), want)


WIRE_CASES = [("float64", "float32"), ("float64", "bfloat16"),
              ("float64", "float16"), ("float32", "bfloat16"),
              ("float32", "float16")]


@pytest.mark.parametrize("shift", [-1, 1])
@pytest.mark.parametrize("dt,wire", WIRE_CASES)
def test_put_signal_wire_plain_matches_jax_ring_bitwise(jax_ring, dt, wire,
                                                        shift):
    """B3w's plain form (the put and the receive buffer in the wire
    dtype) against JAX's ``put_signal(wire_dtype=)`` on near-tie values;
    JAX's result comes back as raw bits."""
    x = torch.from_numpy(jax_ring[f"xw_{dt}"]).reshape(RING, N_LOCAL,
                                                      RING_F)
    idx = torch.tensor(PUT_MAPS["padded"], dtype=torch.int32)
    got = halo_pack.put_signal(x, idx, (RING,), 0, shift, wire_dtype=wire)
    assert got.dtype == getattr(torch, wire)
    bits = got.view(torch.int16 if got.element_size() == 2
                    else torch.int32).numpy()
    want = jax_ring[f"putw_{shift}_{dt}_{wire}"].reshape(RING, len(idx),
                                                         RING_F)
    assert np.array_equal(bits.view(want.dtype), want)


@pytest.mark.parametrize("shift", [-1, 1])
@pytest.mark.parametrize("wire", [None, "float32"])
def test_put_signal_wide_row_plain_matches_jax_ring_bitwise(jax_ring, wire,
                                                            shift):
    """One row of 7,840 elements per domain (M = 1, the forward z pulse's
    kind), which the card's flat grid splits over several blocks: the f32
    bit copy, and the wire form f64 -> f32 on values at and beside f32's
    ties; JAX's wire result comes back as raw bits."""
    key = "wide_x" if wire is None else "wide_xw"
    x = torch.from_numpy(jax_ring[key]).reshape(RING, WIDE_ROWS, WIDE_F)
    idx = torch.tensor(WIDE_MAP, dtype=torch.int32)
    want = jax_ring[f"wide_{shift}" if wire is None else f"widew_{shift}"]
    want = want.reshape(RING, len(WIDE_MAP), WIDE_F)
    for got in (halo_pack.put_signal(x, idx, (RING,), 0, shift,
                                     wire_dtype=wire),
                halo_pack.put_signal_plain(x, idx, (RING,), 0, shift, wire)):
        assert got.dtype == torch.float32
        assert _bits_equal(got.numpy().view(want.dtype), want)


@pytest.mark.parametrize("name", list(FUSED_MAPS))
@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_fused_pulses_plain_matches_jax_ring_bitwise(jax_ring, dt, name):
    x = torch.from_numpy(jax_ring[f"x_{dt}"]).reshape(RING, N_LOCAL, RING_F)
    maps = torch.tensor(FUSED_MAPS[name], dtype=torch.int32)
    got = halo_pack.fused_pulses(x, maps, N_LOCAL, (RING,), 0)
    want = jax_ring[f"fused_{name}_{dt}"].reshape(RING, *maps.shape, RING_F)
    assert _bits_equal(got.numpy(), want)
    pad = (maps < 0).numpy()
    assert not got.numpy()[:, pad].any()         # padding lands as zero rows


def test_signal_puts_on_a_3x2_mesh_follow_the_axis():
    """Each domain of a 3x2 mesh receives from its +1 (shift=-1) or -1
    (shift=+1) neighbour along the named axis only; size 3 tells the two
    shifts apart."""
    src = torch.arange(6 * 4 * 2, dtype=torch.int32).reshape(6, 4, 2)
    idx = torch.tensor([3, -1, 0], dtype=torch.int32)
    packed = halo_pack.pack_plain(src, idx).reshape(3, 2, 3, 2)
    for axis in (0, 1):
        for shift in (-1, 1):
            got = halo_pack.put_signal(src, idx, (3, 2), axis, shift)
            got = got.reshape(3, 2, 3, 2)
            for a, b in np.ndindex(3, 2):
                sa, sb = ((a - shift) % 3, b) if axis == 0 else \
                    (a, (b - shift) % 2)
                assert torch.equal(got[a, b], packed[sa, sb])


@pytest.mark.parametrize("bad,match", [
    ([[0, 6], [1, 2]], "pulse 0"),
    ([[0, 1], [1, 8]], "forwarded rows"),
])
def test_fused_pulses_plain_rejects_bad_maps(bad, match):
    """A pulse-0 forward or an entry past the forwarded rows is a fault of
    the map: the plain form raises (the kernel traps on the card)."""
    src = torch.zeros((2, 6, 3))
    with pytest.raises(IndexError, match=match):
        halo_pack.fused_pulses(src, torch.tensor(bad, dtype=torch.int32), 6,
                               (2,), 0)


def test_signal_wrappers_validate_inputs():
    src = torch.zeros((4, 5, 3))
    idx = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="does not hold"):
        halo_pack.put_signal(src, idx, (3,), 0, -1)
    with pytest.raises(ValueError, match="axis"):
        halo_pack.put_signal(src, idx, (4,), 1, -1)
    with pytest.raises((IndexError, RuntimeError), match="(?i)ind(ex|ices)"):
        halo_pack.put_signal(src, torch.tensor([5], dtype=torch.int32), (4,),
                             0, 1)
    with pytest.raises(ValueError, match="n_local"):
        halo_pack.fused_pulses(src, idx[None], 6, (4,), 0)
    with pytest.raises(TypeError, match="int32"):
        halo_pack.fused_pulses(src, idx[None].long(), 5, (4,), 0)


@pytest.mark.parametrize("wire", [None, "bfloat16"])
def test_put_signal_refuses_a_short_signal_buffer(wire):
    """``signal`` holds the arrival words and a counter per domain: fewer
    than 2 x n_dom words raise, here as on the card, before any launch."""
    src = torch.zeros((4, 5, 3))
    idx = torch.tensor([0, -1], dtype=torch.int32)
    short = torch.zeros((7,), dtype=torch.int32)
    with pytest.raises(ValueError, match="signal holds 7 words, needs 8"):
        halo_pack.put_signal(src, idx, (4,), 0, -1, signal=short,
                             wire_dtype=wire)
    with pytest.raises(TypeError, match="int32"):
        halo_pack.put_signal(src, idx, (4,), 0, -1,
                             signal=torch.zeros((8,), dtype=torch.int64))
    words = torch.zeros((8,), dtype=torch.int32)
    got = halo_pack.put_signal(src, idx, (4,), 0, -1, signal=words,
                               wire_dtype=wire)
    assert torch.equal(got, halo_pack.put_signal_plain(src, idx, (4,), 0,
                                                       -1, wire))


@pytest.mark.parametrize("wire", [None, "bfloat16"])
def test_fused_pulses_refuses_a_short_words_buffer(wire):
    """``words`` holds an arrival word and a counter per (domain, pulse),
    then the ticket: fewer than 2 x n_dom x n_pulses + 1 words raise, here
    as on the card, before any launch.  (``wire`` is put_signal's case
    beside it: fused_pulses always ships dense, so the same words serve a
    plan's wire and dense launches.)"""
    src = torch.zeros((4, 6, 3))
    maps = torch.tensor([[0, 5], [N_LOCAL + 1, -1]], dtype=torch.int32)
    need = halo_pack.fused_pulses_words(4, 2)
    assert need == 2 * 4 * 2 + 1
    short = torch.zeros((need - 1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="words holds 16 words, needs 17"):
        halo_pack.fused_pulses(src, maps, N_LOCAL, (4,), 0, words=short)
    with pytest.raises(TypeError, match="int32"):
        halo_pack.fused_pulses(src, maps, N_LOCAL, (4,), 0,
                               words=torch.zeros((need,), dtype=torch.int64))
    words = torch.zeros((need,), dtype=torch.int32)
    got = halo_pack.fused_pulses(src, maps, N_LOCAL, (4,), 0, words=words)
    assert torch.equal(got, halo_pack.fused_pulses_plain(src, maps, N_LOCAL,
                                                         (4,), 0))
    # the plan's words serve both kernels
    put = halo_pack.put_signal(src, maps[0], (4,), 0, -1, signal=words,
                               wire_dtype=wire)
    assert torch.equal(put, halo_pack.put_signal_plain(src, maps[0], (4,), 0,
                                                       -1, wire))


@pytest.mark.parametrize("mesh_shape,widths,pulses,fused", [
    ((2, 2, 2), (1, 1, 1), None, 0),
    ((3, 2, 1), (1, 1, 1), None, 0),
    ((2, 2, 2), (2, 2, 2), (2, 2, 2), 2 * 8 * 2 + 1),
    ((3, 1, 1), (2, 1, 1), (2, 1, 1), 2 * 3 * 2 + 1)])
def test_signal_backend_words_hold_every_launch(mesh_shape, widths, pulses,
                                                fused):
    """Each ledger slot's signal words serve every launch of that slot:
    2 x n_dom for put_signal (arrival words, then counters) and, where a
    dim has several pulses, 2 x n_dom x pulses + 1 for fused_pulses
    (arrival words, then counters, then the ticket), one buffer a slot;
    two slots share no word."""
    from repro_torch.core.halo_plan import HaloPlan, HaloSpec
    from repro_torch.launch.mesh import make_mesh

    axes = ("z", "y", "x")
    plan = HaloPlan.build(HaloSpec(axes, widths, backend="signal",
                                   pulses=pulses),
                          make_mesh(mesh_shape, axes), device="cpu")
    n_dom = math.prod(mesh_shape)
    put, fp = plan.backend._words(plan, 0)
    assert put.dtype == fp.dtype == torch.int32
    assert (put.numel(), fp.numel()) == (2 * n_dom, fused)
    assert fp.numel() == 0 or fp.data_ptr() == put.data_ptr() + 8 * n_dom
    assert plan.backend._words(plan, 0)[0] is put     # allocated once
    other = plan.backend._words(plan, 1)[0]
    lo, hi = put.data_ptr(), put.data_ptr() + 4 * (2 * n_dom + fused)
    assert not lo <= other.data_ptr() < hi            # a set of its own


# ---- the CUDA kernels against their plain forms (on the card) --------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_dom,p,m,f", [(8, 7, 1, 7840), (8, 56, 8, 1120),
                                         (8, 448, 64, 160), (1, 100, 60, 7),
                                         (3, 16, 128, 3), (1, 7, 1, 7840),
                                         (2, 9, 5, 1)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernels_match_plain_bitwise(cuda_device, n_dom, p, m, f, dtype):
    """The flat word grid at the main path's shapes (the z pulse: M = 1 row
    of 7,840 elements), on one domain, with padding rows and rows of an
    odd width; unpack_add with the inverse given and built here."""
    rng = np.random.RandomState(n_dom + p + m + f)
    src = torch.from_numpy(_src(rng, (n_dom, p, f), dtype)).to(cuda_device)
    idx = torch.from_numpy(rng.randint(-1, p, size=(m,)).astype(np.int32))
    idx = idx.to(cuda_device)
    n0 = halo_pack.pack.launches
    got = halo_pack.pack(src, idx)
    torch.cuda.synchronize()
    assert halo_pack.pack.launches == n0 + 1
    assert torch.equal(got, halo_pack.pack_plain(src, idx))

    uidx = torch.from_numpy(rng.permutation(p)[:min(m, p)].astype(np.int32))
    uidx = uidx.to(cuda_device)
    rows = torch.from_numpy(_src(rng, (n_dom, uidx.shape[0], f), dtype))
    rows = rows.to(cuda_device)
    want = halo_pack.unpack_add_plain(src, uidx, rows)
    n1 = halo_pack.unpack_add.launches
    b1 = halo_pack.unpack_add.inverse_builds
    out = halo_pack.unpack_add(src, uidx, rows)
    torch.cuda.synchronize()
    assert halo_pack.unpack_add.launches == n1 + 1
    assert halo_pack.unpack_add.inverse_builds == b1 + 1
    assert torch.equal(out, want)
    inv = halo_pack.inverse_map(uidx, p)
    assert inv.is_cuda
    out = halo_pack.unpack_add(src, uidx, rows, inv)
    torch.cuda.synchronize()
    assert halo_pack.unpack_add.launches == n1 + 2
    assert halo_pack.unpack_add.inverse_builds == b1 + 1
    assert torch.equal(out, want)


@pytest.mark.cuda
def test_cuda_unaligned_rows_take_scalar_path(cuda_device):
    """Odd row widths and a view offset by one element still agree: rows
    of 5 f32 (4-byte words), and rows of 4 f32 / 2 f64 on bases aligned
    to 4 or 8 bytes only (4- and 8-byte words)."""
    for dtype, F, offset in ((torch.float32, 5, 1), (torch.float32, 4, 1),
                             (torch.float32, 4, 2), (torch.float64, 2, 1)):
        base = torch.randn(3 * 33 * F + offset, device=cuda_device,
                           dtype=dtype)
        src = base[offset:].reshape(3, 33, F)
        idx = torch.tensor([3, -1, 0, 32], dtype=torch.int32,
                           device=cuda_device)
        assert torch.equal(halo_pack.pack(src, idx),
                           halo_pack.pack_plain(src, idx))
        rows = torch.randn(3, 4, F, device=cuda_device, dtype=dtype)
        uidx = torch.tensor([3, 7, 0, 32], dtype=torch.int32,
                            device=cuda_device)
        want = halo_pack.unpack_add_plain(src, uidx, rows)
        assert torch.equal(halo_pack.unpack_add(src, uidx, rows), want)
        assert torch.equal(halo_pack.unpack_add(
            src, uidx, rows, halo_pack.inverse_map(uidx, 33)), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_unpack_add_copies_untouched_rows(cuda_device, dtype):
    """A row the map does not name is copied, not given + 0: -0.0 stays
    -0.0 (and a named row of -0.0 plus +0.0 is +0.0, as in the plain
    form)."""
    dst = torch.full((2, 6, 8), -0.0, dtype=dtype, device=cuda_device)
    rows = torch.zeros((2, 3, 8), dtype=dtype, device=cuda_device)
    idx = torch.tensor([4, 0, 2], dtype=torch.int32, device=cuda_device)
    out = halo_pack.unpack_add(dst, idx, rows, halo_pack.inverse_map(idx, 6))
    want = halo_pack.unpack_add_plain(dst, idx, rows)
    assert torch.equal(torch.signbit(out), torch.signbit(want))
    sign = torch.signbit(out[:, :, 0]).cpu()
    assert sign[:, [1, 3, 5]].all() and not sign[:, [0, 2, 4]].any()


@pytest.mark.cuda
def test_cuda_launches_follow_the_current_stream(cuda_device):
    """A wrapper launches on the stream of ``with torch.cuda.stream(s):``:
    with the default stream held by a sleep, the kernel's result is read
    back on ``s`` before the sleep ends."""
    from repro_torch.kernels import _launch
    rng = np.random.RandomState(5)
    src = torch.from_numpy(rng.randn(8, 448, 160).astype(np.float32))
    src = src.to(cuda_device)
    idx = torch.arange(0, 448, 7, dtype=torch.int32, device=cuda_device)
    want = halo_pack.pack_plain(src, idx).cpu()
    s = torch.cuda.Stream()
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)           # ~1 s on the default stream
    with torch.cuda.stream(s):
        assert _launch.stream(src.get_device()) == s.cuda_stream
        got = halo_pack.pack(src, idx).cpu()
    assert not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_unpack_add_is_one_device_operation(cuda_device):
    """Each unpack_add launch with its inverse is one kernel on the card:
    no Memcpy DtoD before it, no other operation."""
    from torch.profiler import ProfilerActivity, profile
    dst = torch.randn(8, 448, 160, device=cuda_device)
    idx = torch.arange(0, 448, 7, dtype=torch.int32, device=cuda_device)
    rows = torch.randn(8, idx.shape[0], 160, device=cuda_device)
    inv = halo_pack.inverse_map(idx, 448)
    halo_pack.unpack_add(dst, idx, rows, inv)
    torch.cuda.synchronize()
    for _ in range(3):      # CUPTI now and then drops a whole session
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                halo_pack.unpack_add(dst, idx, rows, inv)
            torch.cuda.synchronize()
        ops = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if ops:
            break
    assert len(ops) == 10, ops
    assert all("unpack_add_kernel" in name for name in ops), ops


@pytest.mark.cuda
def test_cuda_engine_runs_through_the_kernels(cuda_device):
    """A 2x2x2 f64 run on the card: pallas launches both kernels, equals
    serialized bitwise, and matches the CPU run to 1e-9."""
    from repro_torch import HaloSpec, MDEngine, make_grappa_like, make_mesh

    s = make_grappa_like(900, seed=3, dtype=np.float64)
    mesh = make_mesh((2, 2, 2), ("z", "y", "x"))
    runs = {}
    builds = halo_pack.unpack_add.inverse_builds
    for dev, backend in (("cuda", "pallas"), ("cuda", "serialized"),
                         ("cpu", "pallas")):
        n0 = (halo_pack.pack.launches, halo_pack.unpack_add.launches)
        eng = MDEngine(s, mesh, HaloSpec(("z", "y", "x"), (1, 1, 1),
                                         backend=backend), device=dev)
        _, m, d = eng.simulate(24)
        n1 = (halo_pack.pack.launches, halo_pack.unpack_add.launches)
        runs[dev, backend] = (m, d, n1[0] - n0[0], n1[1] - n0[1])
    m, d, packs, unpacks = runs["cuda", "pallas"]
    assert packs > 0 and unpacks > 0
    # the plan passes its inverses: none is built per launch
    assert halo_pack.unpack_add.inverse_builds == builds
    assert runs["cuda", "serialized"][2:] == (0, 0)
    ser = runs["cuda", "serialized"]
    for k in ("pe", "ke", "mom"):
        assert np.array_equal(m[k], ser[0][k]), k
    cpu = runs["cpu", "pallas"]
    for k in ("pe", "ke"):
        assert np.abs(m[k] - cpu[0][k]).max() / np.abs(cpu[0][k]).max() < 1e-9
    assert d == ser[1] == cpu[1]


# ---- nonbonded: pair_forces and scatter_accum on the card ------------------

def _nb_arrays(rng, N, K, dtype):
    """N cell pairs of up to K atoms on jittered lattices (atoms >= ~0.7
    apart, pairs across the cutoff), with empty, full and self pairs, as
    numpy arrays."""
    site = np.stack(np.meshgrid(np.arange(4), np.arange(6), np.arange(5),
                                indexing="ij"), -1).reshape(-1, 3)[:K]

    def cells(shift):
        pos = site[None] + shift + rng.uniform(-0.1, 0.1, (N, K, 3))
        q = rng.uniform(-0.5, 0.5, (N, K, 1))
        return np.concatenate([pos, q], -1).astype(dtype)

    # B one lattice step past A's deepest plane: cross pairs interact
    a = cells(np.zeros(3))
    b = cells(np.array([site[:, 0].max() + 1.0, 0.5, 0.5]))
    cnt_a = rng.randint(0, K + 1, N).astype(np.int32)
    cnt_b = rng.randint(0, K + 1, N).astype(np.int32)
    cnt_a[0] = cnt_b[0] = K
    cnt_a[1:2] = cnt_b[1:2] = 0
    same = (rng.uniform(size=N) < 0.2).astype(np.int32)
    b[same > 0], cnt_b[same > 0] = a[same > 0], cnt_a[same > 0]
    slots = np.arange(K)[None, :]
    ta = np.where(slots < cnt_a[:, None], rng.randint(0, 2, (N, K)), -1)
    tb = np.where(slots < cnt_b[:, None], rng.randint(0, 2, (N, K)), -1)
    tb[same > 0] = ta[same > 0]
    return [a, b, ta.astype(np.int32), tb.astype(np.int32), same, cnt_a,
            cnt_b]


def _nb_batch(rng, N, K, dtype, device):
    return [torch.from_numpy(x).to(device)
            for x in _nb_arrays(rng, N, K, dtype)]


def _assert_pair_forces_close(got, want, dtype):
    """5e-6 of the force scale in f32, 1e-12 in f64 (summation order and
    fused multiply-adds differ), PE likewise relative; over the batch
    fa + fb sums to zero within round-off (Newton's third law), as the
    plain form's does."""
    tol = 5e-6 if dtype == np.float32 else 1e-12
    scale = float(torch.maximum(want[0].abs().max(), want[1].abs().max()))
    assert scale > 0
    for g, w in zip(got[:2], want[:2]):
        assert float((g - w).abs().max()) / scale < tol
    assert float((got[2] - want[2]).abs().max()) / \
        max(float(want[2].abs().max()), 1e-300) < tol
    eps = float(np.finfo(dtype).eps)
    for fa, fb in (got[:2], want[:2]):
        total = fa.double().sum((0, 1)) + fb.double().sum((0, 1))
        mass = fa.double().abs().sum() + fb.double().abs().sum()
        assert float(total.abs().max()) <= 8 * eps * float(mass)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["counts", "types"])
@pytest.mark.parametrize("K", [8, 12, 16, 20, 24, 28, 40, 120])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cuda_pair_forces_match_plain(cuda_device, dtype, K, mode):
    """To the tolerances of :func:`_assert_pair_forces_close`; masked work
    exactly zero.  K = 16..28 are the grappa-45k tier depths; K = 40 and
    120 loop the lanes over several column chunks of cell B."""
    from repro_torch.core.md.system import DEFAULT_FF
    from repro_torch.kernels import nonbonded

    a, b, ta, tb, same, cnt_a, cnt_b = _nb_batch(
        np.random.RandomState(K), 300, K, dtype, cuda_device)
    kw = dict(cnt_a=cnt_a, cnt_b=cnt_b) if mode == "counts" else {}
    n0 = nonbonded.pair_forces.launches
    got = nonbonded.pair_forces(a, b, ta, tb, same, DEFAULT_FF, **kw)
    torch.cuda.synchronize()
    assert nonbonded.pair_forces.launches == n0 + 1
    want = nonbonded.pair_forces_plain(a, b, ta, tb, same, DEFAULT_FF, **kw)
    _assert_pair_forces_close(got, want, dtype)
    assert not got[0][1].any() and not got[1][1].any() and got[2][1] == 0
    # the same inputs give the same bits on every run
    again = nonbonded.pair_forces(a, b, ta, tb, same, DEFAULT_FF, **kw)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("N,K", [(1, 8), (1, 28), (13, 8), (13, 12),
                                 (13, 28), (13, 40)])
@pytest.mark.parametrize("mode", ["counts", "types"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cuda_pair_forces_ragged_batches(cuda_device, dtype, mode, N, K):
    """N that no block's pairs divide (a block holds 4, 8 or 16 pairs) and
    N = 1; self pairs of counts 0 and 1; valid slots that are not a prefix
    (types mode reads only the type, so its holes count)."""
    from repro_torch.core.md.system import DEFAULT_FF
    from repro_torch.kernels import nonbonded

    rng = np.random.RandomState(N * K)
    a, b, ta, tb, same, cnt_a, cnt_b = _nb_arrays(rng, N, K, np.float64)
    if N > 3:
        for n, c in ((2, 0), (3, 1)):
            same[n], cnt_a[n], cnt_b[n], b[n] = 1, c, c, a[n]
            ta[n] = tb[n] = np.where(np.arange(K) < c, 0, -1)
    holes = rng.uniform(size=(N, K)) < 0.3
    ta[holes] = -1
    tb[holes & (same[:, None] == 0)] = -1
    tb[same > 0] = ta[same > 0]
    a, b, ta, tb, same, cnt_a, cnt_b = [
        torch.from_numpy(x.astype(dtype) if x.dtype == np.float64 else x)
        .to(cuda_device) for x in (a, b, ta, tb, same, cnt_a, cnt_b)]
    kw = dict(cnt_a=cnt_a, cnt_b=cnt_b) if mode == "counts" else {}
    got = nonbonded.pair_forces(a, b, ta, tb, same, DEFAULT_FF, **kw)
    want = nonbonded.pair_forces_plain(a, b, ta, tb, same, DEFAULT_FF, **kw)
    torch.cuda.synchronize()
    _assert_pair_forces_close(got, want, dtype)
    if N > 3:
        for n in (2, 3):
            assert not got[0][n].any() and not got[1][n].any()
            assert got[2][n] == 0
    again = nonbonded.pair_forces(a, b, ta, tb, same, DEFAULT_FF, **kw)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
def test_cuda_pair_forces_refuses_misaligned_slots(cuda_device):
    """The kernel reads each slot as 16-byte words: a view that starts
    off a 16-byte boundary raises before any launch."""
    from repro_torch.core.md.system import DEFAULT_FF
    from repro_torch.kernels import nonbonded

    a, b, ta, tb, same, cnt_a, cnt_b = _nb_batch(
        np.random.RandomState(0), 4, 8, np.float32, cuda_device)
    off = torch.empty(a.numel() + 1, dtype=a.dtype,
                      device=cuda_device)[1:].view(a.shape)
    off.copy_(a)
    n0 = nonbonded.pair_forces.launches
    with pytest.raises(ValueError, match="16-byte"):
        nonbonded.pair_forces(off, b, ta, tb, same, DEFAULT_FF)
    assert nonbonded.pair_forces.launches == n0


# segment lengths that bracket the kernel's look-ahead (4 entries' rows in
# flight) and its 32 entry ids a load, and one long segment
SEGMENTS = (0, 1, 3, 4, 5, 7, 8, 9, 31, 32, 33, 200)


def _segment_case(dtype, K, seed=0):
    """Cell c of the first len(SEGMENTS) holds SEGMENTS[c] entries, in a
    shuffled worklist (a last cell evens the entry count); the one-entry
    cell's row is -0.0, which the sum from +0.0 turns into +0.0."""
    rng = np.random.RandomState(seed + K)
    ids = np.concatenate([np.full(n, c) for c, n in enumerate(SEGMENTS)])
    n_cells = len(SEGMENTS) + 1
    if len(ids) % 2:
        ids = np.append(ids, n_cells - 1)
    rng.shuffle(ids)
    ca, cb = ids[0::2].astype(np.int32), ids[1::2].astype(np.int32)
    fa = rng.randn(len(ca), K, 3).astype(dtype)
    fb = rng.randn(len(ca), K, 3).astype(dtype)
    one = SEGMENTS.index(1)
    fa[ca == one], fb[cb == one] = -0.0, -0.0
    return ca, cb, fa, fb, n_cells


@pytest.mark.cuda
@pytest.mark.parametrize("K", [7, 8, 13, 28])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cuda_scatter_accum_segment_lengths_bitwise(cuda_device, dtype, K):
    """Segments of 0, 1, 3, 4, 5, 7, 8, 9, 31, 32, 33 and 200 entries;
    K = 7 and 13 take one element a lane (rows that are not whole 16-byte
    words in f32 and f64), K = 8 and 28 16-byte words; bitwise against the
    plain form on the card and on the CPU."""
    from repro_torch.kernels import nonbonded

    ca, cb, fa, fb, n_cells = _segment_case(dtype, K)
    cpu = nonbonded.scatter_accum_plain(
        *(torch.from_numpy(x) for x in (ca, cb, fa, fb)), n_cells)
    args = [torch.from_numpy(x).to(cuda_device) for x in (ca, cb, fa, fb)]
    n0 = nonbonded.scatter_accum.launches
    got = nonbonded.scatter_accum(*args, n_cells)
    torch.cuda.synchronize()
    assert nonbonded.scatter_accum.launches == n0 + 1
    assert torch.equal(got, nonbonded.scatter_accum_plain(*args, n_cells))
    assert got.cpu().numpy().tobytes() == cpu.numpy().tobytes()
    # the whole sums' bits: -0.0 summed from +0.0 is +0.0, as on the CPU
    assert not torch.signbit(got[SEGMENTS.index(1)]).any()
    # a misaligned view takes the one-element path, with the same bits
    fa2 = torch.empty(fa.size + 1, dtype=args[2].dtype,
                      device=cuda_device)[1:].view(fa.shape)
    fa2.copy_(args[2])
    assert torch.equal(nonbonded.scatter_accum(args[0], args[1], fa2,
                                               args[3], n_cells), got)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [8, 28, 40])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cuda_scatter_accum_matches_plain_bitwise(cuda_device, dtype, K):
    from repro_torch.kernels import nonbonded

    rng = np.random.RandomState(K)
    N, n_cells = 5000, 700
    ca = torch.from_numpy(rng.randint(0, n_cells, N).astype(np.int32))
    cb = torch.from_numpy(rng.randint(0, n_cells, N).astype(np.int32))
    ca, cb = ca.to(cuda_device), cb.to(cuda_device)
    fa = torch.from_numpy(rng.randn(N, K, 3).astype(dtype)).to(cuda_device)
    fb = torch.from_numpy(rng.randn(N, K, 3).astype(dtype)).to(cuda_device)
    n0 = nonbonded.scatter_accum.launches
    got = nonbonded.scatter_accum(ca, cb, fa, fb, n_cells)
    torch.cuda.synchronize()
    assert nonbonded.scatter_accum.launches == n0 + 1
    want = nonbonded.scatter_accum_plain(ca, cb, fa, fb, n_cells)
    assert torch.equal(got, want)
    # against the plain form on the CPU too: the same bits on both devices
    cpu = nonbonded.scatter_accum_plain(ca.cpu(), cb.cpu(), fa.cpu(),
                                        fb.cpu(), n_cells)
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.cuda
def test_cuda_pruned_engine_runs_through_the_kernels(cuda_device):
    """A 2x2x2 f64 run with the pallas force backend and the rolling prune
    on the card: all four kernels launch, the pallas and serialized halo
    backends agree bitwise, and the run matches the CPU run to 1e-9."""
    from repro_torch import HaloSpec, MDEngine, make_grappa_like, make_mesh
    from repro_torch.kernels import nonbonded

    s = make_grappa_like(900, seed=3, dtype=np.float64)
    mesh = make_mesh((2, 2, 2), ("z", "y", "x"))
    kernels = (halo_pack.pack, halo_pack.unpack_add, nonbonded.pair_forces,
               nonbonded.scatter_accum)
    runs = {}
    for dev, backend in (("cuda", "pallas"), ("cuda", "serialized"),
                         ("cpu", "pallas")):
        n0 = [k.launches for k in kernels]
        eng = MDEngine(s, mesh, HaloSpec(("z", "y", "x"), (1, 1, 1),
                                         backend=backend),
                       force_backend="pallas", nstprune=4, device=dev)
        (cf, ci), m, d = eng.simulate(24)
        runs[dev, backend] = (m, d, cf.cpu(), [k.launches - n for k, n in
                                               zip(kernels, n0)])
    m, d, cf, launches = runs["cuda", "pallas"]
    assert all(n > 0 for n in launches), launches
    ser = runs["cuda", "serialized"]
    assert ser[3][:2] == [0, 0] and min(ser[3][2:]) > 0
    for k in ("pe", "ke", "mom"):
        assert np.array_equal(m[k], ser[0][k]), k
    assert torch.equal(cf, ser[2]) and d == ser[1]
    cpu = runs["cpu", "pallas"]
    for k in ("pe", "ke"):
        assert np.abs(m[k] - cpu[0][k]).max() / np.abs(cpu[0][k]).max() < 1e-9
    assert d == cpu[1]


# ---- put_signal / fused_pulses on the card ----------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("mesh,axis", [((2, 2, 2), 0), ((2, 2, 2), 2),
                                       ((3, 2, 1), 0), ((3, 2, 1), 1)])
@pytest.mark.parametrize("p,m,f", [(7, 1, 7840), (56, 8, 1120),
                                   (448, 64, 160), (33, 5, 7)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_put_signal_matches_plain_bitwise(cuda_device, dtype, p, m, f,
                                               mesh, axis):
    n_dom = int(np.prod(mesh))
    rng = np.random.RandomState(p + m + f + n_dom)
    src = torch.from_numpy(_src(rng, (n_dom, p, f), dtype)).to(cuda_device)
    idx = torch.from_numpy(rng.randint(-1, p, size=(m,)).astype(np.int32))
    idx = idx.to(cuda_device)
    words = torch.full((2 * n_dom + 3,), -7, dtype=torch.int32,
                       device=cuda_device)
    for shift in (-1, 1):
        n0 = halo_pack.put_signal.launches
        got = halo_pack.put_signal(src, idx, mesh, axis, shift, signal=words)
        torch.cuda.synchronize()
        assert halo_pack.put_signal.launches == n0 + 1
        assert torch.equal(got, halo_pack.put_signal_plain(src, idx, mesh,
                                                           axis, shift))
        assert words[:n_dom].tolist() == [m] * n_dom
        # the counters: every receiver got the same number of words
        assert len(set(words[n_dom:2 * n_dom].tolist())) == 1
        assert words[2 * n_dom:].tolist() == [-7] * 3  # nothing past them


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a tensor whose base lies one element past a
    16-byte boundary (only element words fit it)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def _repeat_put(src, idx, mesh, axis, wire=None, n=200):
    """``n`` back-to-back launches per shift, each checked on the device
    against the plain form, with every arrival word equal to M after each
    one and nothing past the 2 x n_dom words touched."""
    n_dom, M = src.shape[0], idx.shape[0]
    words = torch.full((2 * n_dom + 3,), -7, dtype=torch.int32,
                       device=src.device)
    for shift in (-1, 1):
        want = halo_pack.put_signal_plain(src, idx, mesh, axis, shift, wire)
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            want.element_size()]
        bad = torch.zeros((), dtype=torch.int64, device=src.device)
        bad_words = torch.zeros_like(bad)
        for _ in range(n):
            got = halo_pack.put_signal(src, idx, mesh, axis, shift,
                                       signal=words, wire_dtype=wire)
            bad += (got.view(ints) != want.view(ints)).sum()
            bad_words += (words[:n_dom] != M).sum()
        torch.cuda.synchronize()
        assert got.dtype == want.dtype
        assert int(bad) == 0 and int(bad_words) == 0, (int(bad),
                                                       int(bad_words))
        assert words[2 * n_dom:].tolist() == [-7] * 3


@pytest.mark.cuda
@pytest.mark.parametrize("mesh,axis", [((2, 2, 2), 0), ((2, 2, 2), 2),
                                       ((3, 2, 1), 0), ((3, 2, 1), 1)])
@pytest.mark.parametrize("dtype,p,m,f,aligned", [
    (np.float32, 7, 1, 7840, True),    # a row spans 8 blocks, 16-byte words
    (np.float32, 9, 3, 8, True),       # a block spans every receiver
    (np.float32, 9, 3, 6, True),       # 8-byte words
    (np.float32, 9, 5, 7, True),       # element words
    (np.float32, 7, 1, 7840, False),   # element words, an unaligned base
    (np.int32, 56, 8, 1120, True),
    (np.float64, 7, 1, 3920, True),
    (np.float64, 9, 4, 7, True),       # 8-byte element words
    (np.float64, 9, 4, 6, False)])
def test_cuda_put_signal_repeated_launches_keep_the_words(
        cuda_device, dtype, p, m, f, aligned, mesh, axis):
    """B3's release on the flat grid, launch after launch: rows that span
    several blocks and blocks that span several receivers, every word
    width, padding rows."""
    n_dom = int(np.prod(mesh))
    rng = np.random.RandomState(p + m + f)
    src = torch.from_numpy(_src(rng, (n_dom, p, f), dtype)).to(cuda_device)
    if not aligned:
        src = _misaligned(src)
    idx = rng.randint(-1, p, size=(m,)).astype(np.int32)
    if m > 1:
        idx[-1] = -1
    _repeat_put(src, torch.from_numpy(idx).to(cuda_device), mesh, axis)


def _near_ties(shape, dtype) -> np.ndarray:
    """Values at and beside the f32, f16 and bf16 rounding ties."""
    k = np.arange(int(np.prod(shape)), dtype=np.float64)
    ulp = np.where(k % 3 == 0, 2.0 ** -24, np.where(k % 3 == 1, 2.0 ** -11,
                                                    2.0 ** -8))
    x = (1 + (k % 64) / 64 + ulp + (k % 5 - 2) * 2.0 ** -44) * \
        2.0 ** (k % 17 - 8) * (-1) ** (k // 2)
    return x.astype(dtype).reshape(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh,axis", [((2, 2, 2), 0), ((3, 2, 1), 1)])
@pytest.mark.parametrize("m,f", [(1, 7840), (5, 16), (5, 12), (5, 10),
                                 (5, 7), (5, 6)])
@pytest.mark.parametrize("dt,wire", WIRE_CASES)
def test_cuda_put_signal_wire_repeated_launches_keep_the_words(
        cuda_device, dt, wire, m, f, mesh, axis):
    """B3w at F divisible by 8 (16-byte wire words), by 4 only, by 2 only
    and by none of them, a wide row and short ones, on near-tie values:
    bitwise the plain form (one rounding, as XLA), launch after launch,
    with the arrival words right after each."""
    n_dom = int(np.prod(mesh))
    src = torch.from_numpy(_near_ties((n_dom, 9, f), dt)).to(cuda_device)
    idx = np.arange(m, dtype=np.int32) * 2 % 9
    if m > 1:
        idx[m // 2] = -1
    _repeat_put(src, torch.from_numpy(idx).to(cuda_device), mesh, axis,
                wire=wire)


def _fused_blocks(src, maps):
    """The block count of one fused_pulses launch on the card: P pulses,
    each n_dom x M x V words padded up to whole 256-thread blocks, V the
    row's 16-byte, 8-byte or element words."""
    n_dom, _R, F = src.shape
    P_, M = maps.shape
    row = F * src.element_size()
    w = next((w for w in (16, 8) if w > src.element_size() and row % w == 0
              and src.data_ptr() % w == 0),
             src.element_size())
    V = row // w
    return P_ * -(-n_dom * M * V // 256), M * V


def _repeat_fused(src, maps, n_local, mesh, axes, n=200):
    """``n`` back-to-back launches per axis, each checked on the device
    against the plain form, with every arrival word equal to M after each
    one, the counters and the ticket right after the last, and nothing
    past the 2 x n_dom x P + 1 words touched."""
    n_dom = src.shape[0]
    P_, M = maps.shape
    need = halo_pack.fused_pulses_words(n_dom, P_)
    words = torch.full((need + 3,), -7, dtype=torch.int32,
                       device=src.device)
    blocks, MV = _fused_blocks(src, maps)
    for ax in axes:
        want = halo_pack.fused_pulses_plain(src, maps, n_local, mesh, ax)
        ints = {4: torch.int32, 8: torch.int64}[want.element_size()]
        bad = torch.zeros((), dtype=torch.int64, device=src.device)
        bad_words = torch.zeros_like(bad)
        n0 = halo_pack.fused_pulses.launches
        for _ in range(n):
            got = halo_pack.fused_pulses(src, maps, n_local, mesh, ax,
                                         words=words)
            bad += (got.view(ints) != want.view(ints)).sum()
            bad_words += (words[:n_dom * P_] != M).sum()
        torch.cuda.synchronize()
        assert halo_pack.fused_pulses.launches == n0 + n
        assert int(bad) == 0 and int(bad_words) == 0, (int(bad),
                                                       int(bad_words))
        assert words[n_dom * P_:2 * n_dom * P_].tolist() == \
            [MV] * (n_dom * P_)
        assert int(words[need - 1]) == blocks          # every block's ticket
        assert words[need:].tolist() == [-7] * 3


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FUSED_MAPS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_fused_pulses_matches_plain_bitwise(cuda_device, dtype, name):
    """The crafted maps (dependent and padded pulses; "dep2" the one whose
    first block would straddle the pulses unpadded, "dep3w" pulses of two
    blocks) on a 3x2 mesh along both axes, 200 launches each to shake out
    races on the arrival words."""
    rng = np.random.RandomState(5)
    src = torch.from_numpy(_src(rng, (6, N_LOCAL, 40), dtype))
    src = src.to(cuda_device)
    maps = torch.tensor(FUSED_MAPS[name], dtype=torch.int32,
                        device=cuda_device)
    _repeat_fused(src, maps, N_LOCAL, (3, 2), (0, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("forwarded", [False, True])
@pytest.mark.parametrize("p,m,f", [(7, 1, 7840), (63, 9, 1120),
                                   (567, 81, 160)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_fused_pulses_at_the_two_pulse_shapes(cuda_device, dtype, p, m,
                                                   f, forwarded):
    """The forward z / y / x shapes of a grappa-45k run at widths (2,2,2) /
    pulses (2,2,2) on 2x2x2 domains (rows p, M rows a pulse, F elements a
    row), every word width's grid, with padding rows and, ``forwarded``,
    pulse 1 reading rows of pulse 0's receive buffer."""
    rng = np.random.RandomState(p + m)
    src = torch.from_numpy(_src(rng, (8, p, f), dtype)).to(cuda_device)
    maps = rng.randint(-1, p, size=(2, m)).astype(np.int32)
    if forwarded:
        maps[1, ::2] = p + rng.randint(0, m, size=maps[1, ::2].shape)
    maps = torch.from_numpy(maps).to(cuda_device)
    _repeat_fused(src, maps, p, (2, 2, 2), (0, 2), n=50)


@pytest.mark.cuda
def test_cuda_signal_engine_runs_through_the_kernels(cuda_device):
    """A 2x2x2 f64 run on the card with the signal backend under the
    double-buffered pipeline: put_signal and fused_pulses launch, the run
    equals serialized / off bitwise and the CPU run to 1e-9."""
    from repro_torch import HaloSpec, MDEngine, make_grappa_like, make_mesh

    mesh = make_mesh((2, 2, 2), ("z", "y", "x"))
    kernels = (halo_pack.put_signal, halo_pack.fused_pulses)
    runs = {}
    for dev, backend, kw, pulses in (
            ("cuda", "signal", dict(pipeline="double_buffer",
                                    pipeline_depth=3, overlap_rebin=True),
             None),
            ("cuda", "serialized", {}, None),
            ("cpu", "signal", dict(pipeline="double_buffer"), None),
            ("cuda", "signal", dict(pipeline="double_buffer"), (2, 2, 2)),
            ("cuda", "serialized", {}, (2, 2, 2))):
        n0 = [k.launches for k in kernels]
        widths = (1, 1, 1) if pulses is None else (2, 2, 2)
        # two-pulse dims need local blocks of >= 2 cells: 1600 atoms
        s = make_grappa_like(900 if pulses is None else 1600, seed=3,
                             dtype=np.float64)
        eng = MDEngine(s, mesh, HaloSpec(("z", "y", "x"), widths,
                                         backend=backend, pulses=pulses),
                       device=dev, **kw)
        (cf, ci), m, d = eng.simulate(24)
        runs[dev, backend, pulses] = (m, d, cf.cpu(), [
            k.launches - n for k, n in zip(kernels, n0)])
    sig, ser = runs["cuda", "signal", None], runs["cuda", "serialized", None]
    assert sig[3][0] > 0 and ser[3] == [0, 0]
    for k in ("pe", "ke", "mom"):
        assert np.array_equal(sig[0][k], ser[0][k]), k
    assert torch.equal(sig[2], ser[2]) and sig[1] == ser[1]
    cpu = runs["cpu", "signal", None]
    for k in ("pe", "ke"):
        assert np.abs(sig[0][k] - cpu[0][k]).max() / \
            np.abs(cpu[0][k]).max() < 1e-9
    w2, w2_ser = runs["cuda", "signal", (2, 2, 2)], \
        runs["cuda", "serialized", (2, 2, 2)]
    assert min(w2[3]) > 0
    for k in ("pe", "ke", "mom"):
        assert np.array_equal(w2[0][k], w2_ser[0][k]), k
    assert torch.equal(w2[2], w2_ser[2])
