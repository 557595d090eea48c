"""``remat_policy="dots"`` in the port's LM training against the JAX package.

The reference remats each unit with
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` under
``remat_policy="dots"``; the port runs ``models/remat.py``'s ``"dots"``
policy.  On reduced configs (f32, the reference's weights carried over by
``convert.lm_params_from_jax`` where the two packages are compared):

* the loss and every gradient leaf of qwen3-1.7b and olmoe-1b-7b under
  ``"dots"`` against ``jax.value_and_grad`` of the reference under
  ``"dots"``: loss rtol 1e-5, leaves rtol 1e-5 plus 2e-6 of the leaf's max
  (``tests/test_torch_train.py``'s and ``tests/test_torch_moe.py``'s bars);
* the shapes the policy keeps for one unit, as (rows, columns) of a matrix
  product, equal as a multiset to the residuals that
  ``jax._src.ad_checkpoint.saved_residuals`` reports for the reference's
  ``unit_fn`` under the same policy (its arguments and constants left
  out), for the dense, MoE, RWKV and hybrid archs;
* ``"dots"`` bitwise ``"nothing"`` (loss and every gradient) for every LM
  family, the state-space ones and whisper's encoder-decoder (which, as
  the reference's, ignores the policy) included; the backward runs exactly
  the kept products fewer matrix products than under ``"nothing"``;
* what a product means decides, not its aten name (a ``bmm`` over a
  broadcast weight is kept, a batched one is not, a product only added
  into the output is dropped); a kept product written in place raises;
* an unknown policy raises ``ValueError``; the dry run builds its LM cells
  under ``--remat-policy dots``.

The ``cuda`` cases hold ``"dots"`` on the card against the CPU (f32, 1e-4
of each leaf's max) and against itself (bitwise).  JAX is imported only
inside a fixture (``pytest.importorskip``).
"""
import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import build_model, get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_backward)
from repro_torch.launch import dryrun
from repro_torch.models import remat
from _torch_threads import share_cores  # noqa: E402

QWEN, OLMOE = "qwen3-1.7b", "olmoe-1b-7b"
RWKV, JAMBA, LLAMA4 = "rwkv6-3b", "jamba-v0.1-52b", "llama4-maverick-400b-a17b"
VLM, WHISPER = "internvl2-26b", "whisper-small"
GRAD_TOL = 2e-6            # of a leaf's max, beside rtol 1e-5
B, L = 2, 16               # the loss's batch and inputs (tokens L + 1)


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """Run this module's PyTorch ops on the worker's share of the cores."""
    yield from share_cores()


class Jax:
    """The reference's LMs under ``remat_policy="dots"``."""

    def __init__(self):
        pytest.importorskip("jax")
        import jax
        import jax.numpy as jnp
        from jax._src.ad_checkpoint import saved_residuals
        from repro.configs import get_config as jax_get_config
        from repro.launch.mesh import make_mesh
        from repro.models import build_model as jax_build_model
        from repro.models.layers import cast_floats
        from repro.parallel.sharding import ShardingCtx
        self.jax, self.jnp = jax, jnp
        self.saved_residuals, self.cast_floats = saved_residuals, cast_floats
        self.get_config, self.build_model = jax_get_config, jax_build_model
        self.ctx = ShardingCtx(mesh=make_mesh((1, 1), ("data", "model")),
                               batch_axes=("data",))

    def model(self, arch):
        cfg = dataclasses.replace(self.get_config(arch).reduce(), remat=True,
                                  remat_policy="dots")
        model = self.build_model(cfg, self.ctx)
        return model, self.jax.jit(model.init)(self.jax.random.PRNGKey(1))

    def unit_residuals(self, arch):
        """The residuals of the reference's ``unit_fn`` (the body of
        ``LM._run_stack``'s checkpointed function) for unit 0 under
        ``dots_with_no_batch_dims_saveable``, as (rows, columns, dtype)."""
        jax, jnp = self.jax, self.jnp
        model, params = self.model(arch)
        p0 = jax.tree.map(lambda a: a[0], params["units"])
        x = jnp.ones((B, L, model.cfg.d_model), jnp.float32)
        pos = jnp.broadcast_to(jnp.arange(L), (B, L))

        def unit_fn(p, x):
            p = model._constrain_unit(self.cast_floats(p, model.cdt))
            y, aux, _ = model._unit(p, x, pos)
            return y, aux

        fn = jax.checkpoint(
            unit_fn,
            policy=jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
        return Counter(
            _as_matrix(aval.shape, str(aval.dtype))
            for aval, src in self.saved_residuals(fn, p0, x)
            if not src.startswith(("from the argument", "from a constant")))


@pytest.fixture(scope="module")
def jx():
    return Jax()


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _as_matrix(shape, dtype):
    """A product's output as the matrix it is: (rows, columns, dtype)."""
    return int(np.prod(shape[:-1])), int(shape[-1]), dtype


def _close(got, want, rtol, atol_of_max):
    want = np.asarray(want, np.float64)
    got = np.asarray(torch.as_tensor(got).detach().double())
    atol = atol_of_max * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _tokens(seed=5):
    return np.random.RandomState(seed).randint(0, 512, (B, L + 1)) \
        .astype(np.int32)


def _batch(cfg, device="cpu"):
    batch = {"tokens": torch.from_numpy(_tokens()).to(device)}
    gen = torch.Generator().manual_seed(3)
    if cfg.prefix_tokens:
        batch["prefix_embeds"] = torch.randn(
            B, cfg.prefix_tokens, cfg.d_model, generator=gen).to(device)
    if cfg.encoder_layers:
        batch["frames"] = torch.randn(
            B, cfg.encoder_seq, cfg.d_model, generator=gen).to(device)
    return batch


def _port(arch, policy, device="cpu", seed=1):
    cfg = dataclasses.replace(get_config(arch).reduce(), remat=True,
                              remat_policy=policy)
    model = build_model(cfg, device=device)
    model.init(torch.Generator(device=device).manual_seed(seed))
    return model


def _loss_and_grads(model, batch):
    loss, _ = model.loss_fn(batch)
    loss.backward()
    return loss.detach(), {n: p.grad.detach().clone()
                           for n, p in model.named_parameters()}


class _KeptShapes:
    """Records, for each checkpointed call under ``"dots"``, the kept
    products as (rows, columns, dtype)."""

    def __init__(self, monkeypatch):
        self.calls = []
        finish = remat._Dots._finish

        def record(region, out):
            finish(region, out)
            self.calls.append(Counter(
                _as_matrix(tuple(e[0].shape), str(e[0].dtype).split(".")[-1])
                for e in region.saved if e is not None))
        monkeypatch.setattr(remat._Dots, "_finish", record)


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if remat._is_dot(func, args):
            self.n += 1
        return func(*args, **(kwargs or {}))


# ---- against the reference ------------------------------------------------------

@pytest.mark.parametrize("arch", [QWEN, OLMOE])
def test_dots_loss_and_every_gradient_match_reference(jx, arch):
    model, params = jx.model(arch)
    vg = jx.jax.jit(jx.jax.value_and_grad(model.loss_fn, has_aux=True))
    tokens = _tokens()
    (loss, _), grads = vg(params, {"tokens": jx.jnp.asarray(tokens)})
    port = build_model(dataclasses.replace(
        get_config(arch).reduce(), remat=True, remat_policy="dots"),
        device="cpu")
    port.load_state_dict(lm_params_from_jax(_np(params)))
    got, _ = port.loss_fn({"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    got.backward()
    want = lm_params_from_jax(_np(grads))
    assert sorted(n for n, _ in port.named_parameters()) == sorted(want)
    for name, p in port.named_parameters():
        assert p.grad is not None, name
        _close(p.grad, want[name].numpy(), 1e-5, GRAD_TOL)


@pytest.mark.parametrize("arch", [QWEN, OLMOE, RWKV, JAMBA, LLAMA4])
def test_dots_keeps_the_reference_s_residuals(jx, arch, monkeypatch):
    kept = _KeptShapes(monkeypatch)
    port = _port(arch, "dots")
    port.loss_fn({"tokens": torch.from_numpy(_tokens())})
    assert len(kept.calls) == port.cfg.n_units
    want = jx.unit_residuals(arch)
    assert sum(want.values()) > 0
    assert kept.calls[0] == want


# ---- the port against itself ----------------------------------------------------

@pytest.mark.parametrize("arch", [QWEN, OLMOE, RWKV, JAMBA, LLAMA4, VLM,
                                  WHISPER])
def test_dots_is_nothing_bitwise(arch):
    """Every LM family; whisper's encoder-decoder remats with "nothing"
    whatever the policy, as the reference's does."""
    runs = {}
    for policy in ("nothing", "dots"):
        model = _port(arch, policy)
        runs[policy] = _loss_and_grads(model, _batch(model.cfg))
    (la, ga), (lb, gb) = runs["nothing"], runs["dots"]
    assert torch.equal(la, lb)
    assert ga.keys() == gb.keys()
    for name, g in ga.items():
        assert torch.equal(g, gb[name]), name


@pytest.mark.parametrize("arch", [QWEN, OLMOE])
def test_dots_backward_skips_the_kept_products(arch, monkeypatch):
    kept = _KeptShapes(monkeypatch)
    counts = {}
    for policy in ("nothing", "dots"):
        model = _port(arch, policy)
        loss, _ = model.loss_fn(_batch(model.cfg))
        with _CountProducts() as mode:
            loss.backward()
        counts[policy] = mode.n
    n_kept = sum(sum(c.values()) for c in kept.calls)
    assert n_kept > 0
    assert counts["nothing"] - counts["dots"] == n_kept


def test_dots_follows_what_a_product_means(monkeypatch):
    """A bmm over a weight broadcast along the batch (a strided activation
    times a weight that needs no grad) is kept; a batched bmm is not; the
    last product, only added into the output, is dropped."""
    kept = _KeptShapes(monkeypatch)
    gen = torch.Generator().manual_seed(0)
    wf = torch.randn(8, 8, generator=gen)
    w = torch.randn(4, 8, generator=gen, requires_grad=True)
    x0 = torch.randn(4, 3, 8, generator=gen, requires_grad=True)

    def fn(x, w):
        xt = x.transpose(0, 1)
        a = xt @ wf                                # bmm, weight broadcast
        s = torch.bmm(torch.tanh(a), a.transpose(1, 2))   # batch dims
        h = torch.sigmoid(s).reshape(12, 4) @ w
        return xt.reshape(12, 8) + h

    grads = []
    for policy in (None, "dots"):
        x = x0.detach().clone().requires_grad_()
        w.grad = None
        out = fn(x, w) if policy is None else \
            remat.checkpoint(fn, x, w, policy=policy)
        out.square().sum().backward()
        grads.append((x.grad, w.grad.clone()))
    assert kept.calls == [Counter({(12, 8, "float32"): 1})]
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_a_kept_product_written_in_place_raises():
    x = torch.randn(5, 8, requires_grad=True)
    w = torch.randn(8, 3, requires_grad=True)

    def fn(x, w):
        y = x @ w
        y.add_(1.0)
        return torch.tanh(y)

    out = remat.checkpoint(fn, x, w, policy="dots")
    with pytest.raises(RuntimeError, match="written in place"):
        out.sum().backward()


def test_unknown_remat_policy_raises():
    model = _port(QWEN, "everything")
    with pytest.raises(ValueError, match="'nothing', 'dots'"):
        model.loss_fn({"tokens": torch.from_numpy(_tokens())})


def test_dryrun_builds_lm_cells_under_dots(tmp_path):
    recs = dryrun.main(["--arch", QWEN, "--shape", "train_4k",
                        "--remat-policy", "dots", "--out", str(tmp_path)])
    assert len(recs) == 1 and recs[0]["ok"], recs
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", QWEN, "--remat-policy", "everything",
                     "--out", str(tmp_path)])


# ---- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.fixture
def no_tf32():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.cuda
def test_cuda_dots_matches_cpu_and_repeats_bitwise(cuda_device, no_tf32):
    """Reduced qwen3 under ``"dots"`` on the card (B7 forward and
    recompute, B7b) against the CPU, f32, 1e-4 of each leaf's max; a
    second card run gives the same bits."""
    cpu = _port(QWEN, "dots")
    _, want = _loss_and_grads(cpu, _batch(cpu.cfg))
    runs = []
    for _ in range(2):
        card = _port(QWEN, "dots", device=cuda_device)
        card.load_state_dict(cpu.state_dict())
        flash_attention.launches = flash_attention_backward.launches = 0
        loss, grads = _loss_and_grads(card, _batch(card.cfg, cuda_device))
        n = card.cfg.n_layers
        assert flash_attention.launches == 2 * n
        assert flash_attention_backward.launches == n
        runs.append((loss, grads))
    for name, w in want.items():
        got = runs[0][1][name].cpu()
        assert bool(torch.isfinite(got).all()), name
        assert float((got - w).abs().max()) <= 1e-4 * float(w.abs().max()), \
            name
    assert torch.equal(runs[0][0], runs[1][0])
    for name, g in runs[0][1].items():
        assert torch.equal(g, runs[1][1][name]), name
