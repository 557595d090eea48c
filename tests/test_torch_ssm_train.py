"""Training the port's state-space models against the JAX package.

Same numpy inputs and the same weights through the JAX function and its
counterpart in the port, f32, on ``get_config("rwkv6-3b").reduce()`` and
``get_config("jamba-v0.1-52b").reduce()`` cut to one 8-layer unit (the
pattern whole; a second unit only doubles the reference's trace, 11 s of
its value_and_grad).  The weights are the port's ``init`` from generator
seed 1 (the reference's rules) carried to the reference by
``convert.lm_params_to_jax``; jamba's unit weights are then rescaled to
``1 / sqrt(fan_in)``, as ``chip_smoke.draw_at_fan_in`` draws them on the
card.  At the reference's own scale (``1 / sqrt(n_units)``, 1.0 at one
unit) the reduced jamba is too ill-conditioned for float32 to compare two
summation orders: against a float64 run of the port on the same weights
and tokens, the reference's float32 gradients are up to 1.13e-2 of a
leaf's max away (``mamba.dt_bias``) and the port's 1.79e-2 (measured with
the reference's PRNGKey(1) params, 2 x 17 tokens).

* ``_wkv_scan``'s gradients (``WKVFunction``: one block of states
  recomputed, the reverse recurrence) against ``jax.vjp`` of the
  reference's ``lax.scan``, every input and the initial state, at L = 1,
  7, 256 and 300 (the last two at the default block and at block 64, so
  blocks cross), and a case of fast decays (``w`` down to 1e-9): 1e-5
  of each input's max |grad|;
* what the WKV Function saves: O(L * hd) per input and one state a block,
  never a state a token (``saved_tensors_hooks``); its forward bitwise
  the no-grad path's, which serves;
* ``mamba_fwd``'s gradients (``SelectiveScan``: chunks recomputed from
  their boundary states) against ``jax.vjp`` of the reference's, every
  parameter and the input, at L = 7 (one chunk), 131 (a prime: chunks of
  1), 256 (two of 128) and 300 (three of 100): 1e-5 of max |grad|;
* ``loss_fn`` (rtol 1e-5, every metric) and every gradient of both models
  against ``jax.value_and_grad`` on the train batch: rtol 1e-5 plus a
  share of the leaf's max, 6e-6 for rwkv and 3e-5 for jamba, not
  ``tests/test_torch_train.py``'s 2e-6: both packages' float32 residues
  are that large.  Against a float64 run of the port (same weights and
  tokens), beyond rtol 1e-5: rwkv, the reference 3.14e-6 of a leaf's max
  and the port 4.75e-6 (``rwkv.mu``), the two 3.06e-6 apart; jamba, the
  reference 1.15e-5 (``mamba.A_log``) and the port 1.04e-5, the two
  8.13e-6 apart (``mamba.dt_proj``);
* the first train step at 1 and 2 microbatches against the reference's
  (at 2 its ``make_train_step`` program; at 1 what that program runs at
  one, its ``value_and_grad`` and ``adamw.update``, on the gradient
  program above): metrics rtol 1e-5, params rtol 1e-5 plus 0.1 of the
  peak learning rate.  AdamW's first step moves an element by lr * g /
  (|g| + eps), eps 1e-8: where |g| is of the order of eps, a float32
  residue far under the gradients' noise above (1e-6 of the leaf's max),
  the packages' updates differ by a share of lr, measured up to 1.86e-2
  lr for rwkv and 5.99e-2 lr for jamba (gradients of -1.1e-9 and 2.3e-10);
* a reduced rwkv run killed by ``fail_at_step`` and resumed, bitwise
  equal to an uninterrupted one; the SSM leaves' AdamW state through the
  converter both ways;
* the expert share (``moe_fwd(..., share=)``) on the reduced jamba's MoE
  layer (4 experts, top-2), ``fused`` and ``dense``: the shares' outputs
  (2 x 2, 4 x 1) sum to the whole layer's within 1e-6 of max |out|,
  ``moe_lb`` / ``moe_z`` bitwise the whole layer's in every share, the
  held experts' gradients the whole layer's (1e-6), a count that does not
  divide the experts refused; a share's model, counts and train step, its
  converter slice, the launcher's ``--expert-share`` and checkpoints
  refused;
* an evaluation loss under ``no_grad`` on both models.

JAX is imported only inside a fixture (``pytest.importorskip``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import build_model, get_config
from repro_torch.configs import SHAPES
from repro_torch.convert import (adamw_state_from_jax, adamw_state_to_jax,
                                 lm_params_from_jax, lm_params_to_jax)
from repro_torch.data.synthetic import DataConfig, _batch_at
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as train_launch
from repro_torch.models import mamba as tmamba
from repro_torch.models import moe as tmoe
from repro_torch.models import rwkv as trwkv
from repro_torch.models.layers import _flatten
from repro_torch.models.transformer import _leaf
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime.train_loop import TrainLoopConfig, run_training
from _torch_threads import share_cores  # noqa: E402

JAMBA, RWKV = "jamba-v0.1-52b", "rwkv6-3b"
ARCHES = (RWKV, JAMBA)
GRAD_TOL = 1e-5            # of max |grad|, the scans alone
LM_GRAD_TOL = {RWKV: 6e-6, JAMBA: 3e-5}   # beyond rtol 1e-5, of the leaf's
                                          # max: see the module docstring
SEQ, BATCH = 16, 4
OCFG = dict(lr=8e-3, warmup_steps=2, total_steps=60)
PARAM_ATOL = 0.1 * OCFG["lr"]      # see the module docstring


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """Run this module's PyTorch ops on the worker's share of the cores."""
    yield from share_cores()


def _cfg(arch):
    cfg = get_config(arch).reduce()
    return dataclasses.replace(cfg, n_layers=len(cfg.pattern_unit)) \
        if arch == JAMBA else cfg


class Jax:
    """The reference package's SSM and training pieces, each jitted program
    built once for the module."""

    def __init__(self):
        pytest.importorskip("jax")
        import jax
        import jax.numpy as jnp
        from repro.configs import SHAPES as JSHAPES
        from repro.configs import get_config as jax_get_config
        from repro.launch import steps
        from repro.launch.mesh import make_mesh
        from repro.models import build_model as jax_build_model
        from repro.models import mamba, rwkv
        from repro.optim import adamw
        from repro.parallel.sharding import ShardingCtx
        self.jax, self.jnp, self.steps = jax, jnp, steps
        self.mamba, self.rwkv, self.adamw = mamba, rwkv, adamw
        self.get_config, self.build_model = jax_get_config, jax_build_model
        self.shapes = JSHAPES
        self.ctx = ShardingCtx(mesh=make_mesh((1, 1), ("data", "model")),
                               batch_axes=("data",))
        self._models, self._jit = {}, {}

    def cfg(self, arch):
        cfg = self.get_config(arch).reduce()
        return dataclasses.replace(cfg, n_layers=len(cfg.pattern_unit)) \
            if arch == JAMBA else cfg

    def model(self, arch):
        """(model, params): the port's seeded weights (``_weights``) as the
        reference's tree."""
        if arch not in self._models:
            model = self.build_model(self.cfg(arch), self.ctx)
            tree = lm_params_to_jax(_weights(arch),
                                    len(_cfg(arch).pattern_unit))
            self._models[arch] = model, self.jax.tree_util.tree_map(
                lambda t: self.jnp.asarray(t.numpy()), tree)
        return self._models[arch]

    def jit(self, key, make):
        if key not in self._jit:
            self._jit[key] = make()
        return self._jit[key]

    def vjp(self, key, f, primals, cotangent):
        """``(f(*primals), its vjp at cotangent)``, one jitted program per
        ``key`` (retraced per shape)."""
        def make():
            def both(primals, cotangent):
                out, vjp = self.jax.vjp(f, *primals)
                return out, vjp(cotangent)
            return self.jax.jit(both)
        return self.jit(("vjp", key), make)(primals, cotangent)

    def program(self, arch, mb):
        def make():
            cfg = self.cfg(arch)
            shape = dataclasses.replace(self.shapes["train_4k"],
                                        seq_len=SEQ, global_batch=BATCH)
            ctx = self.steps.make_ctx(cfg, shape, self.ctx.mesh, fsdp=False)
            return self.steps.make_train_step(
                cfg, shape, ctx, ocfg=self.adamw.AdamWConfig(**OCFG),
                microbatches=mb, donate=False)
        return self.jit(("train", arch, mb), make)


@pytest.fixture(scope="module")
def jx():
    return Jax()


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _weights(arch):
    """The reduced model's weights, ``init`` from generator seed 1 (the
    reference's rules); jamba's unit weights then at their fan-in scale,
    ``1 / sqrt(fan_in)``, as ``chip_smoke.draw_at_fan_in`` draws them (see
    the module docstring)."""
    cfg = _cfg(arch)
    model = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(1))
    if arch == JAMBA:
        P = len(cfg.pattern_unit)
        with torch.no_grad():
            for path, d in _flatten(model.defs["units"]).items():
                if d.init == "normal" and d.scale is None:
                    shape = d.shape[1:]
                    fan_in = shape[-2] if len(shape) > 1 else shape[-1]
                    i = int(path[0][len("layer"):])
                    for u in range(cfg.n_units):
                        _leaf(model.layers[u * P + i], path[1:]).mul_(
                            (cfg.n_units / fan_in) ** 0.5)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _close(got, want, rtol, atol_of_max):
    want = np.asarray(want, np.float64)
    got = np.asarray(torch.as_tensor(got).detach().double())
    atol = atol_of_max * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _of_max(got, want, tol, label):
    want = np.asarray(want, np.float64)
    got = np.asarray(torch.as_tensor(got).detach().double())
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (label, err)


def _port_model(arch):
    port = build_model(_cfg(arch), device="cpu")
    port.load_state_dict(_weights(arch))
    return port


# ---- the WKV recurrence -----------------------------------------------------

def _wkv_inputs(L, fast=False, B=2, H=2, hd=8, seed=0):
    rng = np.random.RandomState(seed + L)
    r, k, v = (rng.randn(B, L, H, hd).astype(np.float32) for _ in range(3))
    ww = rng.randn(B, L, H, hd) + (3.0 if fast else 0.0)
    w = np.exp(-np.exp(ww)).astype(np.float32)
    u = rng.randn(H, hd).astype(np.float32)
    S = rng.randn(B, H, hd, hd).astype(np.float32)
    g_out = rng.randn(B, L, H, hd).astype(np.float32)
    g_S = rng.randn(B, H, hd, hd).astype(np.float32)
    return (r, k, v, w, u, S), (g_out, g_S)


@pytest.mark.parametrize("L,block,fast", [
    (1, 256, False), (7, 256, False), (256, 256, False), (256, 64, False),
    (300, 256, False), (300, 64, False), (300, 64, True)])
def test_wkv_gradients_match_reference(jx, L, block, fast):
    ins, (g_out, g_S) = _wkv_inputs(L, fast)
    if fast:
        assert ins[3].min() < 1e-8
    out, want = jx.vjp("wkv", jx.rwkv._wkv_scan,
                       [jx.jnp.asarray(a) for a in ins],
                       (jx.jnp.asarray(g_out), jx.jnp.asarray(g_S)))
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    got_out, got_S = trwkv._wkv_scan(*ts, block=block)
    _of_max(got_out, out[0], GRAD_TOL, "out")
    _of_max(got_S, out[1], GRAD_TOL, "state")
    got = torch.autograd.grad((got_out, got_S), ts,
                              (torch.from_numpy(g_out),
                               torch.from_numpy(g_S)))
    for name, g, w in zip(("r", "k", "v", "w", "u", "state"), got, want):
        assert g.shape == tuple(w.shape), name
        _of_max(g, w, GRAD_TOL, name)


def test_wkv_saves_one_state_a_block():
    """The Function keeps its inputs and a state at each block boundary:
    at L = 300 and block 64, five states, never one a token."""
    B, L, H, hd, block = 2, 300, 2, 8, 64
    ins, _ = _wkv_inputs(L, B=B, H=H, hd=hd)
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out, S = trwkv._wkv_scan(*ts, block=block)
    n_blocks = -(-L // block)
    per_token = L * B * H * hd
    # r, k, v, w (token-major views), u, and the boundary states
    assert sorted(saved) == sorted([per_token] * 4 + [H * hd] +
                                   [n_blocks * B * H * hd * hd])
    assert sum(saved) < L * B * H * hd * hd
    (out.sum() + S.sum()).backward()


def test_wkv_forward_is_the_serving_path_bitwise():
    ins, _ = _wkv_inputs(300)
    ts = [torch.from_numpy(a) for a in ins]
    with torch.no_grad():
        want = trwkv._wkv_scan(*ts, block=64)
    got = trwkv._wkv_scan(*(t.clone().requires_grad_() for t in ts),
                          block=64)
    assert got[0].grad_fn is not None
    for a, b in zip(got, want):
        assert torch.equal(a.detach(), b)


# ---- the selective scan -----------------------------------------------------

def _mamba_inputs(cfg, L, seed=3):
    rng = np.random.RandomState(seed + L)
    p = {}
    for k, d in tmamba.mamba_defs(cfg).items():
        scale = 0.1 if k not in ("A_log", "D") else 1.0
        p[k] = (scale * rng.randn(*d.shape) +
                (1.0 if k in ("A_log", "D") else 0.0)).astype(np.float32)
    x = rng.randn(2, L, cfg.d_model).astype(np.float32)
    g = rng.randn(2, L, cfg.d_model).astype(np.float32)
    return p, x, g


@pytest.mark.parametrize("L", [7, 131, 256, 300])
def test_mamba_gradients_match_reference(jx, L):
    cfg = _cfg(JAMBA)
    p, x, g = _mamba_inputs(cfg, L)
    jcfg = jx.cfg(JAMBA)

    def f(p, x):
        return jx.mamba.mamba_fwd(p, x, jcfg)[0]

    out, (gp, gx) = jx.vjp("mamba", f,
                           [{k: jx.jnp.asarray(v) for k, v in p.items()},
                            jx.jnp.asarray(x)], jx.jnp.asarray(g))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    got, _ = tmamba.mamba_fwd(tp, tx, cfg)
    _of_max(got, out, GRAD_TOL, "out")
    names = list(tp)
    grads = torch.autograd.grad(got, [tp[k] for k in names] + [tx],
                                torch.from_numpy(g))
    for name, gr in zip(names + ["x"], grads):
        _of_max(gr, gp[name] if name != "x" else gx, GRAD_TOL, name)


def test_selective_scan_forward_is_the_serving_path_bitwise():
    cfg = _cfg(JAMBA)
    p, x, _ = _mamba_inputs(cfg, 300)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    with torch.no_grad():
        want, _ = tmamba.mamba_fwd(tp, torch.from_numpy(x), cfg)
    got, _ = tmamba.mamba_fwd(
        {k: v.clone().requires_grad_() for k, v in tp.items()},
        torch.from_numpy(x), cfg)
    assert got.grad_fn is not None
    assert torch.equal(got.detach(), want)


# ---- the models -------------------------------------------------------------

def _shape():
    return dataclasses.replace(SHAPES["train_4k"], seq_len=SEQ,
                               global_batch=BATCH)


def _port_program(arch, mb=1, **kw):
    return tsteps.make_train_step(_cfg(arch), _shape(),
                                  ocfg=tadamw.AdamWConfig(**OCFG),
                                  microbatches=mb, device="cpu", **kw)


def _data_cfg():
    return DataConfig(vocab=512, seq_len=SEQ, global_batch=BATCH, seed=11)


def _value_and_grad(jx, arch, params, tokens):
    """The reference's ``jax.value_and_grad(loss_fn)``, jitted once a
    model (the tests feed it the train batch's shape only)."""
    model, _ = jx.model(arch)
    vg = jx.jit(("value_and_grad", arch), lambda: jx.jax.jit(
        jx.jax.value_and_grad(model.loss_fn, has_aux=True)))
    return vg(params, {"tokens": jx.jnp.asarray(tokens)})


@pytest.mark.parametrize("arch", ARCHES)
def test_loss_and_every_gradient_match_reference(jx, arch):
    _, params = jx.model(arch)
    port = _port_model(arch)
    tokens = _batch_at(_data_cfg(), 0)
    (loss, metrics), grads = _value_and_grad(jx, arch, params, tokens)
    got, got_m = port.loss_fn({"tokens": torch.from_numpy(tokens)})
    assert set(got_m) == set(metrics)
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    for k in got_m:
        np.testing.assert_allclose(float(got_m[k].detach()),
                                   float(metrics[k]), rtol=1e-5)
    got.backward()
    want = lm_params_from_jax(_np(grads))
    names = [n for n, _ in port.named_parameters()]
    assert sorted(names) == sorted(want)
    kind = ".rwkv." if arch == RWKV else ".mamba."
    assert any(kind in n for n in names)
    for name, p in port.named_parameters():
        assert p.grad is not None, name
        _close(p.grad, want[name].numpy(), 1e-5, LM_GRAD_TOL[arch])


def _reference_step(jx, arch, mb, params, batch):
    """The reference's first train step on ``batch``: at two microbatches
    its ``make_train_step`` program; at one, what that program runs at
    one (``value_and_grad`` of ``loss_fn``, then ``adamw.update``),
    through the gradient program the test above compiled.  Returns
    (params, metrics)."""
    if mb == 1:
        (loss, m), grads = _value_and_grad(jx, arch, params, batch)
        update = jx.jit(("update", arch), lambda: jx.jax.jit(
            lambda p, g, o: jx.adamw.update(
                jx.adamw.AdamWConfig(**OCFG), p, g, o)))
        params, _, om = update(params, grads, jx.adamw.init_state(params))
        return params, dict(m, loss=loss, **om)
    jprog = jx.program(arch, mb)
    params = jx.jax.device_put(params, jprog.param_shardings)
    jopt = jx.jax.device_put(jx.adamw.init_state(params), jprog.opt_shardings)
    params, _, m = jprog.step_fn(params, jopt,
                                 {"tokens": jx.jnp.asarray(batch)})
    return params, m


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("arch", ARCHES)
def test_train_step_matches_reference(jx, arch, mb):
    _, params = jx.model(arch)
    prog = _port_program(arch, mb)
    prog.model.load_state_dict(_weights(arch))
    tparams = prog.params
    topt = tadamw.init_state(tparams)
    batch = _batch_at(_data_cfg(), 0)
    params, jm = _reference_step(jx, arch, mb, params, batch)
    tparams, topt, tm = prog.step_fn(tparams, topt,
                                     {"tokens": torch.from_numpy(batch)})
    assert set(tm) == set(jm)
    for name in tm:
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-5)
    want = lm_params_from_jax(_np(params))
    for name, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=PARAM_ATOL)


def test_kill_and_resume_is_bitwise(tmp_path):
    def init():
        return build_model(_cfg(RWKV), device="cpu").init(
            torch.Generator().manual_seed(4)).state_dict()

    loop = TrainLoopConfig(total_steps=4, ckpt_dir=str(tmp_path / "a"),
                           ckpt_every=2, log_every=100)
    p_a, o_a, h_a = run_training(loop, _port_program(RWKV), _data_cfg(),
                                 init, log=None)
    p_a = {k: v.detach().clone() for k, v in p_a.items()}
    loop_b = dataclasses.replace(loop, ckpt_dir=str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="injected failure"):
        run_training(loop_b, _port_program(RWKV), _data_cfg(), init,
                     fail_at_step=3, log=None)
    params, opt, hist = run_training(loop_b, _port_program(RWKV),
                                     _data_cfg(), init, log=None)
    assert [h["step"] for h in hist] == [2, 3]
    for h, w in zip(hist, h_a[2:]):
        assert (h["loss"], h["grad_norm"]) == (w["loss"], w["grad_norm"])
    for name, p in params.items():
        assert torch.equal(p, p_a[name]), name
    for k in opt["m"]:
        assert torch.equal(opt["m"][k], o_a["m"][k])
        assert torch.equal(opt["v"][k], o_a["v"][k])


@pytest.mark.parametrize("arch", ARCHES)
def test_adamw_state_of_ssm_leaves_round_trips(arch):
    model = build_model(_cfg(arch), device="cpu").init(
        torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    gen = torch.Generator().manual_seed(1)
    opt = {"step": torch.tensor(3, dtype=torch.int32),
           "m": {k: torch.randn(p.shape, generator=gen)
                 for k, p in params.items()},
           "v": {k: torch.rand(p.shape, generator=gen)
                 for k, p in params.items()}}
    P = len(model.cfg.pattern_unit)
    tree = adamw_state_to_jax(opt, P)
    kind = "rwkv" if arch == RWKV else "mamba"
    assert any(kind in k for k in tree["m"]["units"]["layer0"])
    back = adamw_state_from_jax(_np(tree))
    assert int(back["step"]) == 3
    for part in ("m", "v"):
        assert back[part].keys() == opt[part].keys()
        for k, t in opt[part].items():
            assert torch.equal(back[part][k], t), (part, k)


@pytest.mark.parametrize("arch", ARCHES)
def test_evaluation_loss_runs_without_grad(arch):
    port = build_model(_cfg(arch), device="cpu").init(
        torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 5), dtype=torch.int32)
    with torch.no_grad():
        loss, _ = port.loss_fn({"tokens": toks})
    assert torch.isfinite(loss) and loss.grad_fn is None


# ---- the expert share -------------------------------------------------------

def _moe_layer(seed=0, tokens=24):
    cfg = _cfg(JAMBA)
    gen = torch.Generator().manual_seed(seed)
    m = cfg.moe
    d = cfg.d_model
    p = {"router": torch.randn(d, m.n_experts, generator=gen),
         "w_gate": 0.2 * torch.randn(m.n_experts, d, m.d_expert,
                                     generator=gen),
         "w_up": 0.2 * torch.randn(m.n_experts, d, m.d_expert, generator=gen),
         "w_down": 0.2 * torch.randn(m.n_experts, m.d_expert, d,
                                     generator=gen)}
    x = torch.randn(2, tokens // 2, d, generator=gen)
    return cfg, p, x


def _share_params(p, share):
    held = tmoe.held_experts(get_config(JAMBA).reduce().moe, share)
    return {k: v if k == "router" else v[held.start:held.stop]
            for k, v in p.items()}


@pytest.mark.parametrize("dispatch", ["fused", "dense"])
@pytest.mark.parametrize("count", [2, 4])
def test_expert_shares_sum_to_the_whole_layer(count, dispatch):
    cfg, p, x = _moe_layer()
    whole, aux = tmoe.moe_fwd(p, x, cfg, dispatch)
    total = torch.zeros_like(whole)
    for i in range(count):
        part, aux_i = tmoe.moe_fwd(_share_params(p, (i, count)), x, cfg,
                                   dispatch, share=(i, count))
        assert bool(part.abs().max() > 0)
        for k in aux:
            assert torch.equal(aux_i[k], aux[k]), k
        total = total + part
    _of_max(total, whole.numpy(), 1e-6, "sum of shares")


def test_expert_share_gradients_are_the_whole_layer_s():
    cfg, p, x = _moe_layer(seed=1)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    whole = {k: v.clone().requires_grad_() for k, v in p.items()}
    out, _ = tmoe.moe_fwd(whole, x, cfg)
    (out * g).sum().backward()
    for i in range(2):
        part = {k: v.clone().requires_grad_()
                for k, v in _share_params(p, (i, 2)).items()}
        out, _ = tmoe.moe_fwd(part, x, cfg, share=(i, 2))
        (out * g).sum().backward()
        for k in ("w_gate", "w_up", "w_down"):
            want = whole[k].grad[2 * i:2 * i + 2]
            assert bool(want.abs().max() > 0), k
            _of_max(part[k].grad, want.numpy(), 1e-6, k)


def test_expert_share_is_refused_unless_it_divides_the_experts():
    cfg, p, x = _moe_layer()
    for share in ((0, 3), (2, 2), (0, 0)):
        with pytest.raises(ValueError, match="expert share"):
            tmoe.moe_fwd(p, x, cfg, share=share)
        with pytest.raises(ValueError, match="expert share"):
            build_model(cfg, device="cpu", expert_share=share)
    with pytest.raises(ValueError, match="MoE"):
        build_model(_cfg(RWKV), device="cpu", expert_share=(0, 2))


def test_expert_share_model_trains_and_converts(tmp_path):
    cfg, share = _cfg(JAMBA), (1, 2)
    prog = _port_program(JAMBA, expert_share=share)
    n = sum(p.numel() for p in prog.params.values())
    assert n == tsteps.param_count(cfg, share) < tsteps.param_count(cfg)
    assert prog.params["layers.1.moe.w_up"].shape[0] == 2
    params = _np(lm_params_to_jax(_weights(JAMBA), len(cfg.pattern_unit)))
    whole = lm_params_from_jax(params)
    sliced = lm_params_from_jax(params, expert_share=share)
    assert sliced.keys() == whole.keys()
    for k, t in sliced.items():
        if k.endswith(("moe.w_gate", "moe.w_up", "moe.w_down")):
            assert torch.equal(t, whole[k][2:4]), k
        else:
            assert torch.equal(t, whole[k]), k
    prog.model.load_state_dict(sliced)
    abstract = tsteps.abstract_params(cfg, share)
    assert tuple(abstract["units"]["layer1"]["moe"]["w_gate"].shape)[1] == 2
    opt = tadamw.init_state(prog.params)
    _, opt, m = prog.step_fn(prog.params, opt,
                             {"tokens": torch.from_numpy(
                                 _batch_at(_data_cfg(), 0))})
    assert all(bool(torch.isfinite(v)) for v in m.values())
    with pytest.raises(ValueError, match="expert share"):
        lm_params_to_jax(prog.params, 8, share)
    with pytest.raises(ValueError, match="expert share"):
        adamw_state_to_jax(opt, 8, share)
    loop = TrainLoopConfig(total_steps=1, ckpt_dir=str(tmp_path),
                           ckpt_every=1, log_every=100)
    with pytest.raises(ValueError, match="expert share"):
        run_training(loop, _port_program(JAMBA, expert_share=share),
                     _data_cfg(), lambda: sliced, log=None)


def test_launcher_trains_an_expert_share_on_cpu(tmp_path, capsys):
    prog, params, opt, hist = train_launch.main(
        ["--arch", JAMBA, "--reduced", "--n-layers", "8",
         "--expert-share", "0/4", "--steps", "2", "--batch", "2", "--seq",
         "8", "--ckpt-every", "0", "--ckpt-dir", str(tmp_path),
         "--device", "cpu"])
    assert prog.model.expert_share == (0, 4)
    assert params["layers.1.moe.w_gate"].shape[0] == 1
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert "expert share 0/4" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        train_launch.parse_args(["--arch", JAMBA, "--expert-share", "0-4"])
