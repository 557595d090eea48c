"""Compressed halo payloads (``wire_dtype``) in the port against JAX.

Bitwise against the JAX package on the same numpy inputs:
* the codec (``WireCodec`` encode / decode / roundtrip and the int8
  helpers) for every format, f32 and f64, with NaN / Inf slots and values
  at and beside the wire grids' ties (``1 + 2**-11 + 2**-40`` rounds to
  1.0009765625 in float16 once, to 1.0 twice);
* B1w's plain form against JAX's ``pack(wire_dtype=)`` in interpret mode
  (B3w's is in ``tests/test_torch_kernels.py``, on JAX's 4-device ring);
* the plan's ``fwd`` / ``rev`` / ``rev_local_ef`` / slot-ring codec on one
  domain for every backend, format and dtype, and its ``stats()``.

The port's pallas and signal backends apply the wrap shifts after the
exchange (``PallasBackend._fwd_wire``), so with shifts they equal the
serialized reference; JAX's kernels round the shifted rows a later dim
forwards once more, so there its pallas equals serialized only without
shifts (pinned below).  Within the port, on 2x2x2 and 3x2x1 virtual
meshes, every backend agrees bitwise per format, ``off ==
double_buffer`` holds at depths 2 and 3, and the int8 scale is one per
domain.  Trajectories of the MD engine are held against JAX's to stated
tolerances.  The ``cuda`` cases hold the converting kernels against their
plain forms on the card and skip without one.
"""
import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import wire
from repro_torch.core.halo_plan import HaloPlan, HaloSpec
from repro_torch.core.pipeline import StepFns, StepPipeline
from repro_torch.kernels import halo_pack
from repro_torch.launch.mesh import make_mesh

AXES = ("z", "y", "x")
FORMATS = ("float32", "bfloat16", "float16", "int8_ef")
BACKENDS = ("serialized", "fused", "pallas", "signal")
CONFIGS = {"w111": ((1, 1, 1), None), "w121": ((1, 2, 1), None),
           "w222p222": ((2, 2, 2), (2, 2, 2))}
LOCAL = (4, 3, 5)
F = 3
TIE = 1 + 2.0 ** -11 + 2.0 ** -40


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """This module's tensors are small: run its PyTorch ops on one CPU
    thread, so that the workers of a parallel test run do not contend
    for cores (the thread count is restored for the next module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules (JAX only where it is installed: the
    card's machine runs the ``cuda`` cases without it)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.core import halo_plan as jhp
    from repro.core import wire as jwire
    from repro.kernels import halo_pack as jpack
    from repro.launch.mesh import make_mesh as jmesh
    return dict(jax=jax, jnp=jnp, wire=jwire, hp=jhp, pack=jpack,
                mesh=jmesh)


@contextlib.contextmanager
def x64(jx, enabled=True):
    """JAX with x64 on (f64 inputs stay f64), restored after."""
    old = jx["jax"].config.jax_enable_x64
    jx["jax"].config.update("jax_enable_x64", enabled)
    try:
        yield
    finally:
        jx["jax"].config.update("jax_enable_x64", old)


def _bits(x):
    """(dtype name, raw bits, NaN mask) of a torch tensor or an array."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        nan = t.isnan().numpy() if t.is_floating_point() else \
            np.zeros(t.shape, bool)
        ints = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[t.element_size()]
        return str(t.dtype).split(".")[-1], t.view(ints).numpy(), nan
    a = np.asarray(x)
    name = a.dtype.name
    nan = np.isnan(a.astype(np.float64)) if a.dtype.kind in "fV" or \
        name == "bfloat16" else np.zeros(a.shape, bool)
    ints = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}
    return name, a.view(ints[a.dtype.itemsize]), nan


def same_bits(got, want) -> bool:
    """Equal dtype, shape and bits (NaN slots only need to be NaN)."""
    (ng, bg, mg), (nw, bw, mw) = _bits(got), _bits(want)
    return (ng == nw and bg.shape == bw.shape and np.array_equal(mg, mw)
            and np.array_equal(bg[~mg], bw[~mw]))


def tie_values(rng, shape, dtype):
    """Random values with NaN / Inf / signed-zero slots and values at and
    beside the float16 and bfloat16 ties, ``TIE`` among them."""
    n = int(np.prod(shape))
    e = rng.randint(-20, 14, n)
    m = rng.randint(0, 1024, n)
    tie = (1 + m / 1024.0 + 2.0 ** -11) * 2.0 ** e
    near = tie * (1 + rng.choice([-1.0, 0.0, 1.0], n)
                  * 2.0 ** rng.randint(-50, -24, n))
    bf = (1 + rng.randint(0, 128, n) / 128.0 + 2.0 ** -8) * 2.0 ** e
    pick = rng.randint(0, 4, n)
    x = np.where(pick == 0, near, np.where(pick == 1, bf,
                                           rng.randn(n) * 3.0))
    x *= rng.choice([-1.0, 1.0], n)
    special = [TIE, -TIE, np.nan, np.inf, -np.inf, 0.0, -0.0, 7e4, 2.0 ** -26]
    x[:len(special)] = special
    return x.astype(dtype).reshape(shape)


# --------------------------------------------------------------------------
# the codec and its constants
# --------------------------------------------------------------------------

def test_constants_and_gate_match_jax(jx):
    jw = jx["wire"]
    assert wire.WIRE_DTYPES == jw.WIRE_DTYPES
    assert wire.WIRE_ITEMSIZE == jw.WIRE_ITEMSIZE
    assert wire.MEASURED_DRIFT == jw.MEASURED_DRIFT
    assert wire.DENSE_F32_DRIFT_BOUND == jw.DENSE_F32_DRIFT_BOUND
    assert wire.VERIFY_MODES == jw.VERIFY_MODES
    for name in (None,) + wire.WIRE_DTYPES + ("float8",):
        for verify in wire.VERIFY_MODES + ("maybe",):
            outs = []
            for mod in (jw, wire):
                try:
                    with pytest.warns(RuntimeWarning) if (
                            name == "int8" and verify == "warn") else \
                            contextlib.nullcontext():
                        outs.append(("ok", mod.gate_wire_config(name,
                                                                verify)))
                except ValueError as e:
                    outs.append((type(e).__name__, str(e)))
            assert outs[0] == outs[1], (name, verify, outs)
    with pytest.raises(ValueError, match="unknown wire_dtype"):
        wire.make_codec("float8")
    assert wire.make_codec(None) is None


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("target", ["float32", "bfloat16", "float16"])
def test_wire_cast_rounds_as_xla(jx, target, dtype):
    if dtype == np.float32 and target == "float32":
        pytest.skip("identity cast")
    x = tie_values(np.random.RandomState(1), (4096,), dtype)
    with x64(jx):
        want = jx["jnp"].asarray(x).astype(getattr(jx["jnp"], target))
    got = wire.wire_cast(torch.from_numpy(x), getattr(torch, target))
    assert same_bits(got, want)
    if dtype == np.float64 and target == "float16":
        # the trap: PyTorch's own cast rounds twice, through float32
        assert float(got[0]) == 1.0009765625
        assert float(torch.tensor(TIE, dtype=torch.float64)
                     .to(torch.float16)) == 1.0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_int8_helpers_match_jax(jx, dtype):
    jw, jnp = jx["wire"], jx["jnp"]
    rng = np.random.RandomState(2)
    cases = [rng.randn(6, 5) * 4.0, tie_values(rng, (6, 5), np.float64),
             np.zeros((6, 5)), np.full((6, 5), np.nan),
             np.r_[np.inf, -np.inf, rng.randn(28)].reshape(6, 5)]
    for x in cases:
        x = x.astype(dtype)
        with x64(jx):
            jxa = jnp.asarray(x)
            js = jw.int8_scale(jxa)
            jq = jw.int8_quantize(jxa, js)
            jd = jw.int8_dequantize(jq, js, jxa.dtype)
            je = jw.int8_encode(jxa)
        t = torch.from_numpy(x)
        s = wire.int8_scale(t)
        q = wire.int8_quantize(t, s)
        assert same_bits(s.reshape(()), js)
        assert same_bits(q, jq)
        assert same_bits(wire.int8_dequantize(q, s, t.dtype), jd)
        for g, w in zip(wire.int8_encode(t), je):
            assert same_bits(g.reshape(w.shape), w)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", wire.WIRE_DTYPES)
def test_codec_matches_jax_bitwise(jx, name, dtype):
    """encode (with and without EF), decode, roundtrip, the forward floor
    and the part shapes, all formats, NaN / Inf and near-tie inputs."""
    rng = np.random.RandomState(3)
    x = tie_values(rng, (5, 4, 6), dtype)
    ef = (rng.randn(5, 4, 6) * 1e-3).astype(dtype)
    jc = jx["wire"].WireCodec(name)
    c = wire.WireCodec(name)
    assert (c.wire_itemsize, c.is_float, c.stateful) == \
        (jc.wire_itemsize, jc.is_float, jc.stateful)
    t, tef = torch.from_numpy(x), torch.from_numpy(ef)
    with x64(jx):
        jnp = jx["jnp"]
        for e, je in ((None, None), (tef, jnp.asarray(ef))):
            jparts, jnew = jc.encode(jnp.asarray(x), je)
            parts, new = c.encode(t, e)
            assert len(parts) == len(jparts)
            for p, jp in zip(parts, jparts):
                assert same_bits(p.reshape(jp.shape), jp)
            assert (new is None) == (jnew is None)
            if new is not None:
                assert same_bits(new, jnew)
            assert same_bits(c.decode(parts, t.dtype),
                             jc.decode(jparts, jnp.asarray(x).dtype))
            y, _ = c.roundtrip(t, e)
            jy, _ = jc.roundtrip(jnp.asarray(x), je)
            assert same_bits(y, jy)
        assert same_bits(c.fwd_roundtrip(t), jc.fwd_roundtrip(jnp.asarray(x)))
    for pdt in (np.float64, np.float32, np.float16):
        assert c.fwd_wire_dtype(np.dtype(pdt)) == jc.fwd_wire_dtype(
            np.dtype(pdt))
        assert c.fwd_itemsize(np.dtype(pdt)) == jc.fwd_itemsize(
            np.dtype(pdt))
    assert c.fwd_wire_dtype(t.dtype) == jc.fwd_wire_dtype(x.dtype)
    if dtype == np.float32:
        assert c.fwd_roundtrip(t) is t          # at the floor: identity
    shapes = c.part_shapes(t.shape, t.dtype)
    assert [tuple(s) for s, _ in shapes] == [tuple(p.shape) for p in parts]
    assert [d for _, d in shapes] == [p.dtype for p in parts]


def test_codec_int8_scale_is_per_domain():
    """With ``n_lead`` domain dims each domain gets its own scale: one
    domain scaled by 1e3 leaves the others' quantization unchanged."""
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 3, 7, 5))
    c = wire.WireCodec("int8_ef", n_lead=2)
    big = x.clone()
    big[1, 2] *= 1e3
    (q, s), _ = c.encode(x, torch.zeros_like(x))
    (qb, sb), _ = c.encode(big, torch.zeros_like(x))
    assert s.shape == (2, 3, 1, 1)
    assert torch.equal(q[:1], qb[:1]) and torch.equal(q[1, :2], qb[1, :2])
    assert torch.equal(s[:1], sb[:1]) and torch.equal(s[1, :2], sb[1, :2])
    assert float(sb[1, 2] / s[1, 2]) == pytest.approx(1e3)
    # each domain's scale is the one-tensor scale of that domain alone
    for i, j in np.ndindex(2, 3):
        assert torch.equal(s[i, j].reshape(()),
                           wire.int8_scale(x[i, j]).reshape(()))


# --------------------------------------------------------------------------
# B1w: the converting pack's plain form against JAX's kernel
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,wire_dtype", [
    (np.float64, "float32"), (np.float64, "bfloat16"),
    (np.float64, "float16"), (np.float32, "bfloat16"),
    (np.float32, "float16")])
def test_pack_wire_plain_matches_jax_bitwise(jx, dtype, wire_dtype):
    rng = np.random.RandomState(5)
    src = tie_values(rng, (60, 7), dtype)
    idx = np.r_[rng.randint(-1, 60, 37), -1, 0, 59].astype(np.int32)
    with x64(jx):
        want = jx["pack"].pack(jx["jnp"].asarray(src),
                               jx["jnp"].asarray(idx), interpret=True,
                               wire_dtype=wire_dtype)
    t, ti = torch.from_numpy(src), torch.from_numpy(idx)
    n0 = (halo_pack.pack.launches, halo_pack.pack.wire_launches)
    got = halo_pack.pack(t[None], ti, wire_dtype=wire_dtype)
    assert same_bits(got[0], want)
    assert same_bits(halo_pack.pack_plain(t[None], ti, wire_dtype)[0], want)
    # the CPU path launches no kernel
    assert (halo_pack.pack.launches, halo_pack.pack.wire_launches) == n0


def test_wire_pack_rejects_what_it_cannot_convert():
    src = torch.zeros((1, 4, 3), dtype=torch.int32)
    idx = torch.tensor([0, 2], dtype=torch.int32)
    for w in ("float16", "float32"):
        with pytest.raises(TypeError, match="no wire conversion"):
            halo_pack.pack(src, idx, wire_dtype=w)
        with pytest.raises(TypeError, match="no wire conversion"):
            halo_pack.put_signal(src, idx, (1,), 0, -1, wire_dtype=w)
    with pytest.raises(TypeError, match="no wire conversion"):
        halo_pack.pack(src.float(), idx, wire_dtype="float64")
    # a wire equal to the source's dtype is the plain bit copy
    x = torch.randn(1, 4, 3)
    assert torch.equal(halo_pack.pack(x, idx, wire_dtype="float32"),
                       halo_pack.pack(x, idx))


# --------------------------------------------------------------------------
# the plan on one domain, against the JAX plan
# --------------------------------------------------------------------------

def _shift():
    s = np.zeros((3, F))
    s[0, 0], s[1, 1], s[2, 2] = 10.0, 20.0, 30.0
    return s


def _port_plan(backend, widths, pulses, wire_dtype, mesh=(1, 1, 1)):
    return HaloPlan.build(
        HaloSpec(AXES, widths, backend=backend, pulses=pulses,
                 wrap_shift=_shift(), wire_dtype=wire_dtype),
        make_mesh(mesh, AXES), device="cpu")


def _jax_plan(jx, backend, widths, pulses, wire_dtype):
    hp = jx["hp"]
    return hp.HaloPlan.build(
        hp.HaloSpec(AXES, widths, backend=backend, pulses=pulses,
                    wrap_shift=_shift(), wire_dtype=wire_dtype),
        jx["mesh"]((1, 1, 1), AXES))


def _blk(a):
    return torch.from_numpy(np.ascontiguousarray(a))[None, None, None]


PLAN_CASES = [(wd, "w111", dt) for wd in FORMATS
              for dt in (np.float64, np.float32)] + \
    [("bfloat16", "w222p222", np.float64)]


@pytest.mark.parametrize("wire_dtype,config,dtype", PLAN_CASES, ids=[
    f"{wd}-{c}-{np.dtype(dt).name}" for wd, c, dt in PLAN_CASES])
def test_plan_one_domain_matches_jax_bitwise(jx, wire_dtype, config, dtype):
    """Every port backend's fwd, rev, the seam's quantize-and-splice
    (with error feedback) and the slot-ring encode / decode against the
    JAX plan.  With the wrap shifts every backend's fwd equals JAX's
    serialized one; without them the pallas and signal fwd also equal
    JAX's own pallas and signal (whose kernels then convert only gridded
    rows).  rev equals JAX's serialized rev (the port's fused rev sums in
    another order, as JAX's does: held to serialized within 1e-12 in
    ``test_virtual_mesh_backends_agree_per_format``)."""
    widths, pulses = CONFIGS[config]
    rng = np.random.RandomState(len(wire_dtype) + sum(widths))
    x = rng.uniform(-5, 5, LOCAL + (F,)).astype(dtype)
    jnp = jx["jnp"]
    with x64(jx):
        jx_ = jnp.asarray(x)
        jref = _jax_plan(jx, "serialized", widths, pulses, wire_dtype)
        want = np.asarray(jref.fwd(jx_))
        y = rng.randn(*want.shape).astype(dtype)
        ef = (rng.randn(*y.shape) * 1e-2).astype(dtype)
        jy, jef = jnp.asarray(y), jnp.asarray(ef)
        want_rev = np.asarray(jref.rev(jy))
        # the seam, run eagerly: under jit XLA contracts the int8_ef
        # residual's multiply and subtract into one FMA (a rounding fewer
        # than its eager codec); the port keeps the eager codec's two
        want_q, want_ef = (np.asarray(a) for a in jref._rev_wire(jy, jef))
        noshift = {b: np.asarray(_jax_plan(jx, b, widths, pulses, wire_dtype)
                                 .fwd(jx_, wrap_shift=None))
                   for b in ("serialized", "pallas", "signal")}
        jparts, jnew = jref.wire_encode_ext(jy, jef)
        want_dec = np.asarray(jref.wire_decode_ext(jparts, jy.dtype))
    for b in BACKENDS:
        plan = _port_plan(b, widths, pulses, wire_dtype)
        assert plan.wire_drift == wire.MEASURED_DRIFT[wire_dtype]
        assert same_bits(plan.fwd(_blk(x))[0, 0, 0], want), b
        got = plan.fwd(_blk(x), wrap_shift=None)[0, 0, 0]
        assert same_bits(got, noshift["serialized"]), b
        if b in noshift:
            assert same_bits(got, noshift[b]), b
        if b != "fused":
            assert same_bits(plan.rev(_blk(y))[0, 0, 0], want_rev), b
        q, new_ef = plan._rev_wire(_blk(y), _blk(ef))
        assert same_bits(q[0, 0, 0], want_q) and \
            same_bits(new_ef[0, 0, 0], want_ef), b
        r, new_ef2 = plan.rev_local_ef(_blk(y), _blk(ef))
        assert torch.equal(r, plan.rev_local_raw(q)), b
        assert torch.equal(new_ef2, new_ef), b
    parts, new = plan.wire_encode_ext(_blk(y), _blk(ef))
    assert len(parts) == len(jparts)
    for p, jp in zip(parts, jparts):
        assert same_bits(p.reshape((1, 1, 1) + tuple(jp.shape))[0, 0, 0], jp)
    assert same_bits(new[0, 0, 0], jnew)
    assert same_bits(plan.wire_decode_ext(parts, _blk(y).dtype)[0, 0, 0],
                     want_dec)


def test_reference_kernels_reround_shifted_rows(jx):
    """The deliberate difference: with wrap shifts and an f64 payload,
    JAX's pallas backend rounds the shifted rows a later dim forwards
    (corner and edge cells) to f32 once more and so differs from its
    serialized backend; the port's pallas backend gives the serialized
    result."""
    x = np.random.RandomState(6).uniform(0, 5, LOCAL + (F,))
    with x64(jx):
        jnp = jx["jnp"]
        ser = np.asarray(_jax_plan(jx, "serialized", (1, 1, 1), None,
                                   "float32").fwd(jnp.asarray(x)))
        pal = np.asarray(_jax_plan(jx, "pallas", (1, 1, 1), None,
                                   "float32").fwd(jnp.asarray(x)))
    # the cells that differ lie in two or more halos (forwarded rows)
    n_halos = sum(np.arange(n + 1).reshape([-1 if k == d else 1
                                            for k in range(4)]) >= n
                  for d, n in enumerate(LOCAL))
    differ = np.any(pal != ser, axis=-1)
    assert differ.any() and (n_halos[..., 0][differ] >= 2).all()
    got = _port_plan("pallas", (1, 1, 1), None, "float32").fwd(_blk(x))
    assert same_bits(got[0, 0, 0], ser)


@pytest.mark.parametrize("kw", [dict(), dict(itemsize=8, feature_elems=160,
                                              index_elems=80, occupancy=0.4),
                                dict(pipeline="double_buffer", depth=3)])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("wire_dtype", (None,) + wire.WIRE_DTYPES)
def test_stats_wire_fields_equal_jax(jx, wire_dtype, dtype, kw):
    hp = jx["hp"]
    spec = dict(backend="signal", dtype=dtype, feature_elems=4,
                wire_dtype=wire_dtype)
    jplan = hp.HaloPlan.build(hp.HaloSpec(AXES, (1, 2, 1), **spec),
                              jx["mesh"]((1, 1, 1), AXES), verify="off")
    plan = HaloPlan.build(HaloSpec(AXES, (1, 2, 1), **spec),
                          make_mesh((2, 2, 2), AXES), device="cpu",
                          verify="off")
    assert plan.stats((7, 7, 7), **kw) == jplan.stats((7, 7, 7), **kw)


def test_multi_hop_plan_ships_and_counts_dense_forward():
    """A halo wider than the block (two hops along y) under a wire: the
    pallas backend ships the f64 forward direction dense, ``stats()``
    counts its bytes dense, and the result is still the serialized one
    bitwise; a one-hop plan ships and counts f32 (the signal backend
    has no multi-hop forwarding)."""
    def plan(backend, widths, pulses=None):
        return HaloPlan.build(
            HaloSpec(AXES, widths, backend=backend, pulses=pulses,
                     wrap_shift=_shift(), wire_dtype="bfloat16",
                     dtype="float64"),
            make_mesh((2, 1, 1), AXES), device="cpu")

    x = torch.from_numpy(np.random.RandomState(9).uniform(
        -5, 5, (2, 1, 1) + LOCAL + (F,)))
    ref = plan("serialized", (1, 4, 1), (1, 2, 1))
    assert ref.stats(LOCAL)["wire_itemsize_fwd"] == 4
    p = plan("pallas", (1, 4, 1), (1, 2, 1))
    st = p.stats(LOCAL)
    assert st["wire_itemsize_fwd"] == 8
    assert st["wire_bytes_fwd"] == st["total_bytes"]
    assert p.backend._fwd_wire(p, x) is None
    assert torch.equal(p.fwd(x), ref.fwd(x))
    one_hop = plan("pallas", (1, 2, 1))
    assert one_hop.stats(LOCAL)["wire_itemsize_fwd"] == 4
    assert one_hop.backend._fwd_wire(one_hop, x) == "float32"


def test_plan_build_gate_and_names():
    mesh = make_mesh((1, 1, 1), AXES)
    with pytest.raises(wire.WireDriftError, match="exceeds the dense-f32"):
        HaloPlan.build(HaloSpec(AXES, (1, 1, 1), wire_dtype="int8"), mesh,
                       device="cpu")
    with pytest.warns(RuntimeWarning, match="exceeds the dense-f32"):
        plan = HaloPlan.build(HaloSpec(AXES, (1, 1, 1), wire_dtype="int8"),
                              mesh, device="cpu", verify="warn")
    assert plan.wire_drift == wire.MEASURED_DRIFT["int8"]
    with pytest.raises(ValueError, match="unknown wire_dtype"):
        HaloSpec(AXES, (1, 1, 1), wire_dtype="nope")
    # the forward floor: f64 payloads pack f32, f32 and integers dense
    plan = HaloPlan.build(HaloSpec(AXES, (1, 1, 1), wire_dtype="bfloat16"),
                          mesh, device="cpu")
    assert plan.wire_pack_dtype(torch.float64) == "float32"
    assert plan.wire_pack_dtype(torch.float32) is None
    assert plan.wire_pack_dtype(torch.int32) is None
    dense = HaloPlan.build(HaloSpec(AXES, (1, 1, 1)), mesh, device="cpu")
    assert dense.wire is None and dense.wire_pack_dtype(torch.float64) is None


# --------------------------------------------------------------------------
# virtual meshes, within the port
# --------------------------------------------------------------------------

MESHES = [(2, 2, 2), (3, 2, 1)]


@pytest.mark.parametrize("wire_dtype", FORMATS)
@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda m: "x".join(
    map(str, m)))
def test_virtual_mesh_backends_agree_per_format(mesh_shape, config,
                                                wire_dtype):
    """f64 payloads with the wrap shifts: fwd, rev and rev_local_ef of
    every backend bitwise equal to serialized (fused rev: 1e-12, its
    accumulation order differs, as in the reference), the body exact."""
    widths, pulses = CONFIGS[config]
    rng = np.random.RandomState(sum(mesh_shape) + len(config))
    x = torch.from_numpy(rng.uniform(-5, 5, tuple(mesh_shape) + LOCAL + (F,)))
    out = {}
    for b in BACKENDS:
        plan = _port_plan(b, widths, pulses, wire_dtype, mesh_shape)
        ext = plan.fwd(x)
        if b == "serialized":
            y = torch.from_numpy(rng.randn(*ext.shape))
            ef = torch.from_numpy(rng.randn(*ext.shape) * 1e-2)
        out[b] = (ext, plan.rev(y), *plan.rev_local_ef(y, ef))
    ref = out["serialized"]
    body = (slice(None),) * 3 + tuple(slice(0, n) for n in LOCAL)
    assert torch.equal(ref[0][body], x)
    assert not torch.equal(ref[0], _port_plan(
        "serialized", widths, pulses, None, mesh_shape).fwd(x))
    for b in BACKENDS:
        assert torch.equal(out[b][0], ref[0]), b
        assert torch.equal(out[b][3], ref[3]), b
        for k in (1, 2):
            if b == "fused":
                assert float((out[b][k] - ref[k]).abs().max()) < 1e-12
            else:
                assert torch.equal(out[b][k], ref[k]), (b, k)


def test_int8_scale_is_per_domain_on_the_mesh():
    """The reference takes the int8 scale per device; on the virtual mesh
    it is one per domain: scaling domain (1, 0, 1)'s forces by 1e3 leaves
    every other domain's quantized rows and scale unchanged."""
    plan = _port_plan("pallas", (1, 1, 1), None, "int8_ef", (2, 2, 2))
    rng = np.random.RandomState(7)
    y = torch.from_numpy(rng.randn(2, 2, 2, 5, 4, 6, F))
    big = y.clone()
    big[1, 0, 1] *= 1e3
    ef = torch.zeros_like(y)
    (q, s, _), _ = plan.wire_encode_ext(y, ef)
    (qb, sb, _), _ = plan.wire_encode_ext(big, ef)
    other = torch.ones((2, 2, 2), dtype=torch.bool)
    other[1, 0, 1] = False
    assert torch.equal(q[other], qb[other]) and torch.equal(s[other],
                                                            sb[other])
    assert not torch.equal(s[1, 0, 1], sb[1, 0, 1])


def test_exchange_gradient_is_the_reverse_exchange():
    """``plan.exchange`` is an autograd function whose backward is ``rev``:
    gradcheck in f64 on a 2x1x1 mesh, and the gradient equals ``rev``
    bitwise."""
    plan = HaloPlan.build(HaloSpec(AXES, (1, 2, 1), backend="pallas",
                                   wrap_shift=_shift()),
                          make_mesh((2, 1, 1), AXES), device="cpu")
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(2, 1, 1, 3, 3, 2, F)).requires_grad_()
    assert torch.autograd.gradcheck(plan.exchange, (x,))
    out = plan.exchange(x)
    assert torch.equal(out, plan.fwd(x.detach()))
    g = torch.from_numpy(rng.randn(*out.shape))
    grad, = torch.autograd.grad(out, x, g)
    assert torch.equal(grad, plan.rev(g))


# --------------------------------------------------------------------------
# the step pipeline with a wire format
# --------------------------------------------------------------------------

def _toy_fns():
    """The reference's toy physics (``tests/test_pipeline.py``) on block
    tensors: ``aux`` is each domain's own sum."""
    def begin(state, f, ctx):
        state = state + 0.1 * f
        return state, state.sum(dim=(1, 2), keepdim=True), state

    def force(ext, ctx):
        F_ = torch.tanh(ext) * ctx
        return F_, {"pe": torch.sum(F_)}

    def finish(state, aux, f, ctx):
        state = state + 0.01 * f + 1e-3 * aux
        return state, f, {"ke": torch.sum(state)}

    return StepFns(begin=begin, force=force, finish=finish)


@functools.lru_cache(maxsize=None)
def _wire_cell(wire_dtype, backend, mode, depth, n_dom, dtype, n_steps=8):
    plan = HaloPlan.build(HaloSpec(("z",), (1,), backend=backend,
                                   wire_dtype=wire_dtype),
                          make_mesh((n_dom,), ("z",)), device="cpu")
    pipe = StepPipeline.build(plan, _toy_fns(), mode=mode, depth=depth)
    x0 = np.random.RandomState(0).randn(n_dom * 6, 4).reshape(n_dom, 6, 4)
    x0 = torch.from_numpy(x0.astype(dtype))
    state, f, metrics, _ = pipe.run_local(x0, torch.zeros_like(x0), n_steps,
                                          torch.tensor(0.5, dtype=x0.dtype))
    return state, f, metrics


@pytest.mark.parametrize("depth", [2, 3, 4])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("wire_dtype", FORMATS)
def test_wire_conformance_matrix(wire_dtype, backend, depth):
    """``off`` == ``double_buffer`` bitwise per format and backend, on 1
    and 3 domains, f32 and f64 payloads, and every backend equal to the
    serialized / off cell."""
    for n_dom in (1, 3):
        for dtype in (np.float32, np.float64):
            ref = _wire_cell(wire_dtype, "serialized", "off", 2, n_dom, dtype)
            for mode in ("off", "double_buffer"):
                got = _wire_cell(wire_dtype, backend, mode, depth, n_dom,
                                 dtype)
                assert torch.equal(got[0], ref[0]), (mode, n_dom, dtype)
                assert torch.equal(got[1], ref[1]), (mode, n_dom, dtype)
                for k in ref[2]:
                    assert torch.equal(got[2][k], ref[2][k]), k


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_wire_compression_is_live(dtype):
    dense = _wire_cell(None, "fused", "off", 2, 3, dtype)
    comp = _wire_cell("bfloat16", "fused", "off", 2, 3, dtype)
    d = float((dense[0] - comp[0]).abs().max())
    assert 0 < d < 1e-1, d
    if dtype == np.float64:
        # f64 forces rounded to f32 on return: float32 differs as well
        assert not torch.equal(
            _wire_cell("float32", "fused", "off", 2, 3, dtype)[0], dense[0])


def test_wire_none_is_the_dense_run():
    """``wire_dtype=None`` runs the dense pipeline unchanged (the same
    cell as a plan built without the field)."""
    plan = HaloPlan.build(HaloSpec(("z",), (1,), backend="fused"),
                          make_mesh((3,), ("z",)), device="cpu")
    pipe = StepPipeline.build(plan, _toy_fns(), mode="double_buffer",
                              depth=3)
    x0 = torch.from_numpy(np.random.RandomState(0).randn(18, 4)
                          .reshape(3, 6, 4).astype(np.float32))
    state, f, _, _ = pipe.run_local(x0, torch.zeros_like(x0), 8,
                                    torch.tensor(0.5))
    got = _wire_cell(None, "fused", "double_buffer", 3, 3, np.float32)
    assert torch.equal(got[0], state) and torch.equal(got[1], f)


# --------------------------------------------------------------------------
# the MD engine with a wire format, against JAX
# --------------------------------------------------------------------------

# per-step PE / KE relative to their scale, final positions relative to the
# box, for every format: the port's f64 forces agree with JAX's to ~1e-15
# (measured on these inputs, every format), and the wire rounds them the
# same way unless one lies within that distance of a wire tie.  The limit
# sits well below each format's own effect on this run, which the test
# measures against JAX's dense run, so a port that ignored the format or
# reset the int8_ef residual between steps would fail it.
MD_TOL = 1e-12
_JAX_MD = {}


def _jax_md(jx, wire_dtype):
    """JAX's 20-step f64 run at ``wire_dtype`` (cached per format):
    ``(system, metrics, positions by id, diagnostics, halo stats)``."""
    if wire_dtype not in _JAX_MD:
        from repro.core.md import MDEngine as JaxMDEngine
        from repro.core.md import make_grappa_like as jax_make_grappa_like

        hp = jx["hp"]
        with x64(jx):
            s = jax_make_grappa_like(300, seed=11, dtype=np.float64)
            jeng = JaxMDEngine(s, jx["mesh"]((1, 1, 1), AXES),
                               hp.HaloSpec(AXES, (1, 1, 1), backend="fused"),
                               wire_dtype=wire_dtype)
            (jcf, jci), jm, jd = jeng.simulate(20)
            jpos, = jeng.gather_by_id([jcf[..., :3]], jci)
            _JAX_MD[wire_dtype] = (s, jm, np.asarray(jpos), jd,
                                   jeng.halo_stats())
    return _JAX_MD[wire_dtype]


def _md_gaps(s, m, pos, jm, jpos):
    """Per-step PE / KE gaps relative to their scale, and the final
    positions' gap relative to the box."""
    gaps = {k: float(np.abs(np.asarray(m[k]) - np.asarray(jm[k])).max()
                     / np.abs(np.asarray(jm[k])).max()) for k in ("pe", "ke")}
    gaps["pos"] = float(np.abs(np.asarray(pos) - jpos).max() / s.box[0])
    return gaps


@pytest.mark.parametrize("wire_dtype", FORMATS)
def test_md_f64_matches_jax_per_format(jx, wire_dtype):
    """A 20-step f64 run (one nstlist block after the first rebin) of the
    port's pallas backend against the JAX engine's fused backend with the
    same wire format (JAX's pallas rounds the shifted corner rows again,
    see above; the dense payload is ``tests/test_torch_md.py``'s)."""
    from repro_torch.convert import system_from_jax
    from repro_torch.core.md import MDEngine

    s, jm, jpos, jd, jstats = _jax_md(jx, wire_dtype)
    eng = MDEngine(system_from_jax(s), make_mesh((1, 1, 1), AXES),
                   HaloSpec(AXES, (1, 1, 1), backend="pallas"),
                   wire_dtype=wire_dtype, device="cpu")
    assert eng.wire_dtype == wire_dtype
    (cf, ci), m, d = eng.simulate(20)
    pos, = eng.gather_by_id([cf[..., :3]], ci)
    gaps = _md_gaps(s, m, pos, jm, jpos)
    assert max(gaps.values()) < MD_TOL, gaps
    # the limit lies below the effect it guards: JAX's own run at this
    # format moves every checked quantity further from its dense run
    _, dm, dpos, _, _ = _jax_md(jx, None)
    effect = _md_gaps(s, jm, jpos, dm, dpos)
    assert min(effect.values()) > MD_TOL, effect
    assert [[int(x[k]) for k in sorted(x)] for x in d] == \
        [[int(np.asarray(x[k])) for k in sorted(x)] for x in jd]
    assert {k: v for k, v in eng.halo_stats().items()} == jstats


def test_md_wire_backends_agree_on_2x2x2():
    """The three halo backends under their pipelines, bitwise, on a 2x2x2
    mesh in f64 with int8_ef (the chip smoke's check, every format, at a
    small size)."""
    from repro_torch.core.md import MDEngine, make_grappa_like

    s = make_grappa_like(900, seed=3, dtype=np.float64)
    mesh = make_mesh((2, 2, 2), AXES)
    for wd in ("int8_ef",):      # the stateful format: EF in both modes
        runs = []
        for backend, kw in (("pallas", {}),
                            ("signal", dict(pipeline="double_buffer")),
                            ("serialized", {})):
            eng = MDEngine(s, mesh, HaloSpec(AXES, (1, 1, 1),
                                             backend=backend),
                           wire_dtype=wd, device="cpu", **kw)
            (cf, ci), m, d = eng.simulate(3)
            runs.append((cf, ci, m, d))
        for r in runs[1:]:
            assert torch.equal(r[0], runs[0][0]) and r[3] == runs[0][3]
            for k in ("pe", "ke", "mom"):
                assert np.array_equal(r[2][k], runs[0][2][k]), (wd, k)


def test_force_pass_copies_nothing_from_the_host(monkeypatch):
    """C1: once its constants exist, a dense force pass builds no tensor
    from host data (on the card each would be a blocking copy)."""
    from repro_torch.core.md import MDEngine, make_grappa_like

    s = make_grappa_like(300, seed=11, dtype=np.float64)
    eng = MDEngine(s, make_mesh((1, 1, 1), AXES),
                   HaloSpec(AXES, (1, 1, 1), backend="pallas"),
                   wire_dtype="bfloat16", device="cpu")
    cf, ci, _f, _d = eng.rebin_fn(*eng.init_state())
    want = eng.force_fn(cf, ci)

    def refuse(*a, **k):
        raise AssertionError("torch.tensor called on the step path")
    monkeypatch.setattr(torch, "tensor", refuse)
    got = eng.force_fn(cf, ci)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# --------------------------------------------------------------------------
# the converting kernels on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,wire_dtype", [
    (np.float64, "float32"), (np.float64, "bfloat16"),
    (np.float64, "float16"), (np.float32, "bfloat16"),
    (np.float32, "float16")])
@pytest.mark.parametrize("n_dom,p,m,f", [(8, 448, 64, 160), (8, 56, 8, 1120),
                                         (6, 33, 5, 10), (6, 33, 5, 7),
                                         (6, 33, 5, 6)])
def test_cuda_wire_kernels_match_plain_bitwise(cuda_device, dtype,
                                               wire_dtype, n_dom, p, m, f):
    rng = np.random.RandomState(p + m)
    src = torch.from_numpy(tie_values(rng, (n_dom, p, f), dtype))
    src = src.to(cuda_device)
    idx = torch.from_numpy(rng.randint(-1, p, size=(m,)).astype(np.int32))
    idx = idx.to(cuda_device)
    n0 = halo_pack.pack.wire_launches
    got = halo_pack.pack(src, idx, wire_dtype=wire_dtype)
    torch.cuda.synchronize()
    assert halo_pack.pack.wire_launches == n0 + 1
    assert same_bits(got, halo_pack.pack_plain(src, idx, wire_dtype))
    mesh = (n_dom // 2, 2, 1)
    for axis, shift in ((0, -1), (1, 1)):
        n1 = halo_pack.put_signal.wire_launches
        got = halo_pack.put_signal(src, idx, mesh, axis, shift,
                                   wire_dtype=wire_dtype)
        torch.cuda.synchronize()
        assert halo_pack.put_signal.wire_launches == n1 + 1
        assert same_bits(got, halo_pack.put_signal_plain(
            src, idx, mesh, axis, shift, wire_dtype))


WIRE_CONVERSIONS = [(np.float64, "float32"), (np.float64, "bfloat16"),
                    (np.float64, "float16"), (np.float32, "bfloat16"),
                    (np.float32, "float16")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,wire_dtype", WIRE_CONVERSIONS)
@pytest.mark.parametrize("n_dom,p,m,f,offset", [
    (6, 33, 5, 6, 0), (6, 33, 5, 10, 0), (6, 33, 5, 7, 0),
    (6, 33, 5, 6, 1), (6, 33, 5, 10, 1), (6, 33, 5, 7, 1),
    (8, 7, 1, 7840, 0)])
def test_cuda_pack_wire_flat_grid_words(cuda_device, dtype, wire_dtype,
                                        n_dom, p, m, f, offset):
    """B1w on its flat grid: rows of F = 6 and 10 (8-byte wire words, or
    4 source elements where the wire is 16-bit and F allows), F = 7 (one
    element a thread), each also from a base one element past a 16-byte
    boundary (the 8-byte and one-element paths), and the forward z pulse's
    one wide row; bitwise the plain form on near-tie values, padding rows
    included."""
    rng = np.random.RandomState(f + offset)
    vals = torch.from_numpy(tie_values(rng, (n_dom, p, f), dtype))
    flat = torch.empty(vals.numel() + offset, dtype=vals.dtype,
                       device=cuda_device)
    src = flat[offset:].view(vals.shape)
    src.copy_(vals)
    idx = rng.randint(0, p, size=(m,)).astype(np.int32)
    if m > 1:
        idx[1::3] = -1
    idx = torch.from_numpy(idx).to(cuda_device)
    n0 = halo_pack.pack.wire_launches
    got = halo_pack.pack(src, idx, wire_dtype=wire_dtype)
    torch.cuda.synchronize()
    assert halo_pack.pack.wire_launches == n0 + 1
    assert same_bits(got, halo_pack.pack_plain(src, idx, wire_dtype))
    assert same_bits(got, halo_pack.pack_plain(vals, idx.cpu(), wire_dtype))


@pytest.mark.cuda
def test_cuda_wire_engine_runs_through_the_kernels(cuda_device):
    """A 2x2x2 f64 bfloat16-wire run on the card: the converting pack and
    put launch, pallas == signal/double_buffer == serialized bitwise."""
    from repro_torch.core.md import MDEngine, make_grappa_like

    s = make_grappa_like(900, seed=3, dtype=np.float64)
    mesh = make_mesh((2, 2, 2), AXES)
    runs = {}
    for backend, kw in (("pallas", {}), ("signal",
                                         dict(pipeline="double_buffer")),
                        ("serialized", {})):
        n0 = (halo_pack.pack.wire_launches, halo_pack.put_signal.wire_launches)
        eng = MDEngine(s, mesh, HaloSpec(AXES, (1, 1, 1), backend=backend),
                       wire_dtype="bfloat16", device="cuda", **kw)
        (cf, ci), m, d = eng.simulate(24)
        runs[backend] = (cf, m, (halo_pack.pack.wire_launches - n0[0],
                                 halo_pack.put_signal.wire_launches - n0[1]))
    assert runs["pallas"][2][0] > 0 and runs["signal"][2][1] > 0
    assert runs["serialized"][2] == (0, 0)
    for b in ("pallas", "signal"):
        assert torch.equal(runs[b][0], runs["serialized"][0])
        for k in ("pe", "ke", "mom"):
            assert np.array_equal(runs[b][1][k], runs["serialized"][1][k])
