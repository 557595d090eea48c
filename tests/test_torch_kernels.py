"""Port's halo pack / unpack-add against the JAX Pallas kernels, bitwise.

The JAX side runs its kernels in interpret mode on the CPU; the port's
oracles (``kernels/ref.py``) and its wrappers' plain forms (which CPU
tensors take) must give identical bits for f32, f64 and int32.  The
``cuda`` cases hold the CUDA kernels against the plain forms on the card
and skip without one.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import halo_pack, ref

DTYPES = [np.float32, np.float64, np.int32]
SHAPES = [(64, 32, 4), (100, 60, 7), (16, 128, 3)]


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


@pytest.mark.parametrize("dtype", DTYPES)
def test_unpack_add_batched_cpu_matches_jax_bitwise(jk, dtype):
    rng = np.random.RandomState(11)
    dst = _src(rng, (8, 40, 5), dtype)
    rows = _src(rng, (8, 12, 5), dtype)
    idx = rng.permutation(40)[:12].astype(np.int32)
    got = halo_pack.unpack_add(torch.from_numpy(dst), torch.from_numpy(idx),
                               torch.from_numpy(rows))
    for b in range(8):
        assert _bits_equal(got[b].numpy(),
                           jk.unpack_add(dst[b], idx, rows[b]))


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
    before = (halo_pack.pack.launches, halo_pack.unpack_add.launches)
    src = torch.ones((2, 5, 3))
    idx = torch.tensor([0, 2], dtype=torch.int32)
    halo_pack.unpack_add(src, idx, halo_pack.pack(src, idx))
    assert (halo_pack.pack.launches, halo_pack.unpack_add.launches) == before


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
                                         (3, 16, 128, 3)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernels_match_plain_bitwise(cuda_device, n_dom, p, m, f, dtype):
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
    n1 = halo_pack.unpack_add.launches
    out = halo_pack.unpack_add(src, uidx, rows)
    torch.cuda.synchronize()
    assert halo_pack.unpack_add.launches == n1 + 1
    assert torch.equal(out, halo_pack.unpack_add_plain(src, uidx, rows))


@pytest.mark.cuda
def test_cuda_unaligned_rows_take_scalar_path(cuda_device):
    """Odd row widths and a view offset by one element still agree."""
    base = torch.randn(3 * 33 * 5 + 1, device=cuda_device)
    src = base[1:].reshape(3, 33, 5)          # 4-byte aligned only
    idx = torch.tensor([3, -1, 0, 32], dtype=torch.int32,
                       device=cuda_device)
    assert torch.equal(halo_pack.pack(src, idx),
                       halo_pack.pack_plain(src, idx))
    rows = torch.randn(3, 4, 5, device=cuda_device)
    uidx = torch.tensor([3, 7, 0, 32], dtype=torch.int32, device=cuda_device)
    assert torch.equal(halo_pack.unpack_add(src, uidx, rows),
                       halo_pack.unpack_add_plain(src, uidx, rows))


@pytest.mark.cuda
def test_cuda_engine_runs_through_the_kernels(cuda_device):
    """A 2x2x2 f64 run on the card: pallas launches both kernels, equals
    serialized bitwise, and matches the CPU run to 1e-9."""
    from repro_torch import HaloSpec, MDEngine, make_grappa_like, make_mesh

    s = make_grappa_like(900, seed=3, dtype=np.float64)
    mesh = make_mesh((2, 2, 2), ("z", "y", "x"))
    runs = {}
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
    assert runs["cuda", "serialized"][2:] == (0, 0)
    ser = runs["cuda", "serialized"]
    for k in ("pe", "ke", "mom"):
        assert np.array_equal(m[k], ser[0][k]), k
    cpu = runs["cpu", "pallas"]
    for k in ("pe", "ke"):
        assert np.abs(m[k] - cpu[0][k]).max() / np.abs(cpu[0][k]).max() < 1e-9
    assert d == ser[1] == cpu[1]
