"""The port's Mixture-of-Experts against the JAX package.

Same numpy inputs and the same weights (the reference LM's params carried
over by ``convert.lm_params_from_jax``) through the JAX function and its
counterpart in the port, on ``get_config("olmoe-1b-7b").reduce()`` (4
experts, top-2, MoE on every layer) and
``get_config("llama4-maverick-400b-a17b").reduce()`` (top-1, a shared
expert, MoE on every second layer), both f32 with the reference's
one-device ``("data", "model")`` mesh:

* routing and dispatch tables (``_route``, ``_capacity``,
  ``_dispatch_tables``, ``_scatter_tokens``, ``_gather_outputs``) on a
  plain router, one with drops (capacity 4 for 64 tokens, skewed) and one
  that leaves an expert without tokens: ``top_e`` / ``slot`` / ``keep``
  bitwise, values within 1e-6;
* ``moe_fwd`` for ``fused`` and ``dense`` (and ``fused`` with drops)
  within 1e-5 of max |out|; the port's ``fused`` bitwise equal to its
  ``serialized``; the reference's zero "remote" half exact zeros;
* ``prefill`` / ``decode_step`` logits within 1e-5 of max |logit| and
  greedy ``serve_wave`` tokens equal;
* ``loss_fn``'s ``loss``, ``ce``, ``moe_lb``, ``moe_z`` within rtol 1e-5
  and every gradient leaf at rtol 1e-5 plus 2e-6 of the leaf's max (the
  bar of ``tests/test_torch_train.py``) on olmoe, 4e-6 on llama4: its four
  layers leave the deep attention leaves (``wq``, ``q_norm``) with f32
  residues of cancelling sums in both packages -- against a float64 run
  of the port on the same weights and tokens, the reference's f32
  gradients reach 2.47e-6 of a leaf's max beyond rtol 1e-5 and the
  port's 2.15e-6, and the two differ by up to 2.74e-6;
* two ``make_train_step`` steps against the reference's at that file's
  parameter bar; two port runs bitwise; a killed-and-resumed run equal to
  an uninterrupted one;
* the converter round trip with ``moe`` leaves, ``active_param_count``
  for every config the port builds, the launchers on the CPU.

JAX is imported only inside a fixture (``pytest.importorskip``), and its
programs are compiled once per module; the ``cuda`` cases run on the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import BatchServer, build_model, get_config
from repro_torch.configs import SHAPES
from repro_torch.configs.base import MoECfg
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.convert import (adamw_state_from_jax, adamw_state_to_jax,
                                 lm_params_from_jax, lm_params_to_jax)
from repro_torch.data.synthetic import DataConfig, _batch_at
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as train_launch
from repro_torch.models import moe as tmoe
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime.serve_loop import Request
from repro_torch.runtime.train_loop import TrainLoopConfig, run_training
from _torch_threads import share_cores  # noqa: E402

OLMOE, LLAMA4 = "olmoe-1b-7b", "llama4-maverick-400b-a17b"
ARCHES = (OLMOE, LLAMA4)
F32_TOL = 1e-5
GRAD_TOL = {OLMOE: 2e-6, LLAMA4: 4e-6}   # of a leaf's max; see above
SEQ, BATCH = 16, 4
WAVE_LEN = 20              # max_len of the serving tests
OCFG = dict(lr=8e-3, warmup_steps=2, total_steps=60)
PARAM_ATOL = 1e-2 * OCFG["lr"]     # tests/test_torch_train.py's bar


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """Run this module's PyTorch ops on the worker's share of the cores."""
    yield from share_cores()


class Jax:
    """The reference package's MoE and LM pieces, each jitted program built
    once for the module."""

    def __init__(self):
        pytest.importorskip("jax")
        import jax
        import jax.numpy as jnp
        from repro.configs import SHAPES as JSHAPES
        from repro.configs import get_config as jax_get_config
        from repro.configs.base import MoECfg
        from repro.launch import steps
        from repro.launch.mesh import make_mesh
        from repro.models import build_model as jax_build_model
        from repro.models import moe
        from repro.optim import adamw
        from repro.parallel.sharding import ShardingCtx
        from repro.runtime import serve_loop
        self.jax, self.jnp, self.moe, self.MoECfg = jax, jnp, moe, MoECfg
        self.steps, self.adamw, self.serve_loop = steps, adamw, serve_loop
        self.get_config, self.build_model = jax_get_config, jax_build_model
        self.shapes = JSHAPES
        self.ctx = ShardingCtx(mesh=make_mesh((1, 1), ("data", "model")),
                               batch_axes=("data",))
        self._models, self._jit = {}, {}

    def cfg(self, arch):
        return self.get_config(arch).reduce()

    def model(self, arch):
        """(model, params) of the reduced config, ``PRNGKey(1)``, once (the
        init jitted: one compile, not one a leaf shape)."""
        if arch not in self._models:
            model = self.build_model(self.cfg(arch), self.ctx)
            self._models[arch] = model, self.jax.jit(model.init)(
                self.jax.random.PRNGKey(1))
        return self._models[arch]

    def jit(self, key, make):
        if key not in self._jit:
            self._jit[key] = make()
        return self._jit[key]

    def server(self, arch):
        """The reference's ``BatchServer`` of ``arch`` (its jitted prefill
        and decode serve the model tests too), batch 3, max_len 20."""
        def make():
            model, params = self.model(arch)
            return self.serve_loop.BatchServer(model, params, batch_size=3,
                                               max_len=WAVE_LEN)
        return self.jit(("server", arch), make)


@pytest.fixture(scope="module")
def jx():
    return Jax()


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _port_model(jx, arch, dispatch="fused"):
    _, params = jx.model(arch)
    model = build_model(get_config(arch).reduce(), device="cpu",
                        moe_dispatch=dispatch)
    model.load_state_dict(lm_params_from_jax(_np(params)))
    return model


def _rel(want, got):
    want = np.asarray(want, np.float64)
    got = np.asarray(torch.as_tensor(got).detach().double())
    return np.abs(want - got).max() / max(np.abs(want).max(), 1e-30)


def _close(got, want, rtol, atol_of_max):
    want = np.asarray(want, np.float64)
    got = np.asarray(torch.as_tensor(got).detach().double())
    atol = atol_of_max * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# ---- routing and dispatch tables --------------------------------------------

E, K, D = 8, 2, 16


def _router_case(case):
    """(x2d, router, capacity_factor) for a table case."""
    rng = np.random.RandomState({"plain": 0, "drops": 1, "empty": 2}[case])
    T = 64 if case == "drops" else 24
    x = rng.randn(T, D).astype(np.float32)
    w = (0.5 * rng.randn(D, E)).astype(np.float32)
    cf = 8.0
    if case == "drops":
        x[:, 0] = np.abs(x[:, 0]) + 1.0      # skew: experts 0, 1 favoured
        w[0, :2] += 3.0
        cf = 0.1                             # capacity 4
    if case == "empty":
        x[:, 1] = np.abs(x[:, 1]) + 1.0
        w[1, 5] -= 20.0                      # expert 5 never in a top-2
    return x, w, cf


@pytest.mark.parametrize("case", ["plain", "drops", "empty"])
def test_route_and_dispatch_tables_match_reference(jx, case):
    x, w, cf = _router_case(case)
    T = x.shape[0]
    jm = jx.MoECfg(n_experts=E, top_k=K, d_expert=32, capacity_factor=cf)
    tm = MoECfg(n_experts=E, top_k=K, d_expert=32, capacity_factor=cf)
    cap = tmoe._capacity(T, tm, E)
    assert cap == jx.moe._capacity(T, jm, E)
    out_buf = np.random.RandomState(7).randn(E, cap, D).astype(np.float32)

    def tables(x, w, out_buf):          # the reference's, in one program
        e, g, aux = jx.moe._route(x, w, jm)
        slot, keep = jx.moe._dispatch_tables(e, g, E, cap)
        return (e, g, aux, slot, keep,
                jx.moe._scatter_tokens(x, slot, keep, E, cap, K),
                jx.moe._gather_outputs(out_buf, slot, keep, g, T, K))

    je, jg, jaux, js, jk, jbuf, jo = jx.jax.jit(tables)(
        *map(jx.jnp.asarray, (x, w, out_buf)))
    te, tg, taux = tmoe._route(torch.from_numpy(x), torch.from_numpy(w), tm)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    for k in ("moe_lb", "moe_z"):
        assert taux[k].dtype == torch.float32 and taux[k].dim() == 0
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-6)

    ts, tk = tmoe._dispatch_tables(te, tg, E, cap)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    counts = np.bincount(np.asarray(je).reshape(-1), minlength=E)
    if case == "drops":
        assert cap == 4 and not tk.all() and counts.max() > cap
    elif case == "empty":
        assert counts[5] == 0 and tk.all()
    else:
        assert tk.all()

    tbuf = tmoe._scatter_tokens(torch.from_numpy(x), ts, tk, E, cap, K)
    assert tbuf.shape == (E, cap, D)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    to = tmoe._gather_outputs(torch.from_numpy(out_buf), ts, tk, tg, T, K)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-6)


@pytest.mark.parametrize("tokens", [1, 4, 37, 1024, 4096])
@pytest.mark.parametrize("arch", ARCHES)
def test_capacity_matches_reference(jx, arch, tokens):
    for reduced in (False, True):
        tc, jc = get_config(arch), jx.get_config(arch)
        if reduced:
            tc, jc = tc.reduce(), jc.reduce()
        assert tmoe._capacity(tokens, tc.moe, tc.moe.n_experts) == \
            jx.moe._capacity(tokens, jc.moe, jc.moe.n_experts)
    # olmoe at full size: 644 slots an expert for 4 x 1024 prefill tokens,
    # 4 for a 4-token decode step
    m = get_config(OLMOE).moe
    assert tmoe._capacity(4096, m, 64) == 644
    assert tmoe._capacity(4, m, 64) == 4


def test_top_k_breaks_ties_as_lax_top_k(jx):
    logits = np.array([[1.0, 3.0, 3.0, 0.5, 3.0], [2.0, 2.0, 2.0, 2.0, 2.0],
                       [0.0, -1.0, 5.0, 5.0, -1.0]], np.float32)
    jv, ji = jx.jax.lax.top_k(jx.jnp.asarray(logits), 3)
    tv, ti = tmoe._top_k(torch.from_numpy(logits), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ---- the MoE layer ----------------------------------------------------------

def _layer_inputs(jx, arch, T=40, cf=None):
    """(jax cfg, port cfg, params as numpy, x (2, T/2, d)) for one MoE layer
    of ``arch`` reduced (the model's layer-1 weights), capacity factor
    ``cf`` if given."""
    _, params = jx.model(arch)
    i = max(n for n, s in enumerate(jx.cfg(arch).pattern_unit) if s.moe)
    p = {k: v for k, v in _np(params["units"][f"layer{i}"]["moe"]).items()}
    p = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict)
             else v[0]) for k, v in p.items()}
    jc, tc = jx.cfg(arch), get_config(arch).reduce()
    if cf is not None:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(
            jc.moe, capacity_factor=cf))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, capacity_factor=cf))
    x = np.random.RandomState(3).randn(2, T // 2, tc.d_model) \
        .astype(np.float32)
    return jc, tc, p, x


def _torch_tree(p):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in p.items()}


def _jax_moe(jx, jc, dispatch, p, x):
    fn = jx.jit(("moe_fwd", jc, dispatch), lambda: jx.jax.jit(
        lambda p, x: jx.moe.moe_fwd(p, x, jc, jx.ctx, dispatch)))
    return fn(jx.jax.tree.map(jx.jnp.asarray, p), jx.jnp.asarray(x))


@pytest.mark.parametrize("dispatch,cf", [("fused", None), ("dense", None),
                                         ("fused", 0.5)],
                         ids=["fused", "dense", "fused-drops"])
@pytest.mark.parametrize("arch", ARCHES)
def test_moe_fwd_matches_reference(jx, arch, dispatch, cf):
    jc, tc, p, x = _layer_inputs(jx, arch, cf=cf)
    want, jaux = _jax_moe(jx, jc, dispatch, p, x)
    got, taux = tmoe.moe_fwd(_torch_tree(p), torch.from_numpy(x), tc,
                             dispatch)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert _rel(want, got) <= F32_TOL
    for k in ("moe_lb", "moe_z"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-6)
    if cf is not None:                   # the case drops assignments
        m, T = tc.moe, x.shape[0] * x.shape[1]
        top_e, top_g, _ = tmoe._route(torch.from_numpy(x).reshape(T, -1),
                                      torch.from_numpy(p["router"]), m)
        _, keep = tmoe._dispatch_tables(
            top_e, top_g, m.n_experts, tmoe._capacity(T, m, m.n_experts))
        assert not keep.all()


@pytest.mark.parametrize("arch", ARCHES)
def test_fused_is_serialized_bitwise_and_skips_an_exact_zero(jx, arch):
    jc, tc, p, x = _layer_inputs(jx, arch, cf=0.5)
    tp, tx = _torch_tree(p), torch.from_numpy(x)
    fused, fa = tmoe.moe_fwd(tp, tx, tc, "fused")
    serial, sa = tmoe.moe_fwd(tp, tx, tc, "serialized")
    assert torch.equal(fused, serial)
    assert all(torch.equal(fa[k], sa[k]) for k in fa)
    # the reference's fused adds the expert FFN of an all-zero buffer:
    # exact zeros for both MLP types, so the port leaves it out
    cap = tmoe._capacity(x.shape[0] * x.shape[1], tc.moe, tc.moe.n_experts)
    zeros = jx.jnp.zeros((tc.moe.n_experts, cap, tc.d_model), jx.jnp.float32)
    for mlp_type in ("swiglu", "gelu"):
        y = jx.moe._expert_ffn(p["w_gate"], p["w_up"], p["w_down"], zeros,
                               mlp_type, None)
        assert not np.asarray(y).any()


def test_moe_fwd_refuses_an_unknown_dispatch():
    with pytest.raises(ValueError, match="dispatch"):
        build_model(get_config(OLMOE).reduce(), device="cpu",
                    moe_dispatch="ring")
    cfg = get_config(OLMOE).reduce()
    with pytest.raises(ValueError, match="dispatch"):
        tmoe.moe_fwd({}, torch.zeros(1, 1, cfg.d_model), cfg, "ring")


# ---- the model: serving -----------------------------------------------------

@pytest.mark.parametrize("arch", ARCHES)
def test_prefill_and_decode_match_reference(jx, arch):
    model, params = jx.model(arch)
    port = _port_model(jx, arch)
    rng = np.random.RandomState(4)
    B, L, max_len = 3, 7, WAVE_LEN      # the wave test's shapes
    toks = rng.randint(0, model.cfg.vocab, size=(B, L)).astype(np.int32)
    prefill = jx.server(arch)._prefill
    want, _ = prefill(params, {"tokens": jx.jnp.asarray(toks)})
    got, none = port.prefill({"tokens": torch.from_numpy(toks)})
    assert none is None and _rel(want, got) <= F32_TOL
    jc = model.init_cache(B, max_len)
    want, jc = prefill(params, {"tokens": jx.jnp.asarray(toks)}, jc)
    tc = port.init_cache(B, max_len)
    got, tc = port.prefill({"tokens": torch.from_numpy(toks)}, tc)
    assert _rel(want, got) <= F32_TOL
    decode = jx.server(arch)._decode
    for t in range(3):
        tok = rng.randint(0, model.cfg.vocab, size=(B, 1)).astype(np.int32)
        want, jc = decode(params, jx.jnp.asarray(tok), jx.jnp.int32(L + t),
                          jc)
        got, tc = port.decode_step(torch.from_numpy(tok), L + t, tc)
        assert _rel(want, got) <= F32_TOL, t


@pytest.mark.parametrize("arch", ARCHES)
def test_greedy_wave_tokens_equal_reference(jx, arch):
    model, _ = jx.model(arch)
    port = _port_model(jx, arch)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, model.cfg.vocab, size=(n,)).astype(np.int32)
               for n in (5, 7, 3)]          # ragged: left pads take slots
    want = jx.server(arch).serve_wave([jx.serve_loop.Request(
        prompt=p, max_new_tokens=4) for p in prompts])
    got = BatchServer(port, batch_size=3, max_len=WAVE_LEN).serve_wave(
        [Request(prompt=p, max_new_tokens=4) for p in prompts])
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.out_tokens, w.out_tokens)


def test_dense_and_fused_prefill_agree_without_drops(jx):
    """The reduced configs' capacity factor 8 drops nothing, so the oracle
    and the capacity path compute the same sums in f32."""
    toks = torch.from_numpy(np.random.RandomState(6).randint(
        0, 512, (2, 11)).astype(np.int32))
    fused, _ = _port_model(jx, OLMOE).prefill({"tokens": toks})
    dense, _ = _port_model(jx, OLMOE, "dense").prefill({"tokens": toks})
    assert _rel(dense.numpy(), fused) <= F32_TOL


# ---- loss, gradients, training ----------------------------------------------

@pytest.mark.parametrize("arch", ARCHES)
def test_loss_and_every_gradient_match_reference(jx, arch):
    model, params = jx.model(arch)
    port = _port_model(jx, arch)
    tokens = np.random.RandomState(5).randint(0, 512, (2, 17)) \
        .astype(np.int32)
    vg = jx.jit(("value_and_grad", arch), lambda: jx.jax.jit(
        jx.jax.value_and_grad(model.loss_fn, has_aux=True)))
    (loss, metrics), grads = vg(params, {"tokens": jx.jnp.asarray(tokens)})
    got, got_m = port.loss_fn({"tokens": torch.from_numpy(tokens)})
    assert set(got_m) == set(metrics) == {"ce", "moe_lb", "moe_z"}
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    for k in got_m:
        np.testing.assert_allclose(float(got_m[k].detach()),
                                   float(metrics[k]), rtol=1e-5)
    got.backward()
    want = lm_params_from_jax(_np(grads))
    names = [n for n, _ in port.named_parameters()]
    assert sorted(names) == sorted(want)
    assert any(".moe.w_gate" in n for n in names)
    for name, p in port.named_parameters():
        assert p.grad is not None, name
        _close(p.grad, want[name].numpy(), 1e-5, GRAD_TOL[arch])


def test_aux_terms_sum_over_layers_in_reference_order(jx):
    """``moe_lb`` is the sum of the MoE layers' own terms, and the loss
    divides the aux terms by n_layers (not by the count of MoE layers)."""
    port = _port_model(jx, LLAMA4)
    tokens = torch.from_numpy(np.random.RandomState(8).randint(
        0, 512, (2, 9)).astype(np.int32))
    terms = []
    real = tmoe._route

    def spy(*a):
        out = real(*a)
        terms.append(out[2])
        return out

    tmoe._route = spy
    try:
        with torch.no_grad():
            loss, m = port.loss_fn({"tokens": tokens})
    finally:
        tmoe._route = real
    assert len(terms) == 2             # llama4 reduced: 4 layers, 2 MoE
    for k in ("moe_lb", "moe_z"):
        assert torch.equal(m[k], terms[0][k] + terms[1][k])
    n = port.cfg.n_layers
    want = m["ce"] + 0.01 * m["moe_lb"] / n + 1e-3 * m["moe_z"] / n
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-7)


def _shape():
    return dataclasses.replace(SHAPES["train_4k"], seq_len=SEQ,
                               global_batch=BATCH)


def _port_program(dispatch="fused"):
    return tsteps.make_train_step(get_config(OLMOE).reduce(), _shape(),
                                  ocfg=tadamw.AdamWConfig(**OCFG),
                                  microbatches=1, device="cpu",
                                  moe_dispatch=dispatch)


def _data_cfg():
    return DataConfig(vocab=512, seq_len=SEQ, global_batch=BATCH, seed=11)


def test_train_step_matches_reference(jx):
    def make():
        cfg = jx.cfg(OLMOE)
        shape = dataclasses.replace(jx.shapes["train_4k"], seq_len=SEQ,
                                    global_batch=BATCH)
        ctx = jx.steps.make_ctx(cfg, shape, jx.ctx.mesh, fsdp=False)
        return jx.steps.make_train_step(
            cfg, shape, ctx, ocfg=jx.adamw.AdamWConfig(**OCFG),
            microbatches=1, moe_dispatch="fused", donate=False)

    jprog = jx.jit(("train", OLMOE), make)
    _, params = jx.model(OLMOE)
    prog = _port_program()
    prog.model.load_state_dict(lm_params_from_jax(_np(params)))
    tparams = prog.params
    topt = tadamw.init_state(tparams)
    # on the program's own shardings, as its outputs are: the second
    # step then reuses the first's compile
    params = jx.jax.device_put(params, jprog.param_shardings)
    jopt = jx.jax.device_put(jx.adamw.init_state(params),
                             jprog.opt_shardings)
    for step in range(2):
        batch = _batch_at(_data_cfg(), step)
        params, jopt, jm = jprog.step_fn(params, jopt,
                                         {"tokens": jx.jnp.asarray(batch)})
        tparams, topt, tm = prog.step_fn(tparams, topt,
                                         {"tokens": torch.from_numpy(batch)})
        assert set(tm) == set(jm) == {"loss", "ce", "moe_lb", "moe_z",
                                      "grad_norm", "lr"}
        for name in tm:
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-5)
    want = lm_params_from_jax(_np(params))
    for name, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=PARAM_ATOL)


def _init_from(jx):
    _, params = jx.model(OLMOE)
    return lambda: lm_params_from_jax(_np(params))


def test_two_runs_bitwise_and_kill_resume(jx, tmp_path):
    init = _init_from(jx)
    loop = TrainLoopConfig(total_steps=4, ckpt_dir=str(tmp_path / "a"),
                           ckpt_every=2, log_every=100)
    p_a, o_a, h_a = run_training(loop, _port_program(), _data_cfg(), init,
                                 log=None)
    p_a = {k: v.detach().clone() for k, v in p_a.items()}
    assert all(set(h) >= {"ce", "moe_lb", "moe_z"} for h in h_a)
    loop_b = dataclasses.replace(loop, ckpt_dir=str(tmp_path / "b"))
    p_b, _, h_b = run_training(loop_b, _port_program(), _data_cfg(), init,
                               log=None)
    assert [{k: v for k, v in h.items() if k != "dt"} for h in h_a] == \
        [{k: v for k, v in h.items() if k != "dt"} for h in h_b]
    for name, p in p_b.items():
        assert torch.equal(p, p_a[name]), name

    loop_c = dataclasses.replace(loop, ckpt_dir=str(tmp_path / "c"))
    with pytest.raises(RuntimeError, match="injected failure"):
        run_training(loop_c, _port_program(), _data_cfg(), init,
                     fail_at_step=3, log=None)
    params, opt, hist = run_training(loop_c, _port_program(), _data_cfg(),
                                     init, log=None)
    assert [h["step"] for h in hist] == [2, 3]
    for h, w in zip(hist, h_a[2:]):
        assert (h["loss"], h["grad_norm"], h["moe_lb"]) == \
            (w["loss"], w["grad_norm"], w["moe_lb"])
    for name, p in params.items():
        assert torch.equal(p, p_a[name]), name
    assert int(opt["step"]) == int(o_a["step"]) == 4


# ---- plumbing ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHES)
def test_converter_round_trips_moe_leaves(jx, arch):
    model, params = jx.model(arch)
    port = _port_model(jx, arch)
    P = len(port.cfg.pattern_unit)
    sd = dict(port.named_parameters())
    moe_names = [n for n in sd if ".moe." in n]
    assert moe_names and all(sd[n].dim() in (1, 2, 3) for n in moe_names)
    back = lm_params_to_jax(sd, P)
    want = _np(params)

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), v

    got = dict(leaves(_np(back)))
    ref = dict(leaves(want))
    assert got.keys() == ref.keys()
    for path, v in ref.items():
        np.testing.assert_array_equal(got[path], v)
    # the reference's own declaration: every leaf, stacked, at its shape
    decl = dict(leaves(model.abstract()))
    assert decl.keys() == got.keys()
    for path, a in decl.items():
        assert tuple(a.shape) == got[path].shape, path
    i = max(n for n, s in enumerate(port.cfg.pattern_unit) if s.moe)
    E, d, f = (port.cfg.moe.n_experts, port.cfg.d_model,
               port.cfg.moe.d_expert)
    assert got[("units", f"layer{i}", "moe", "w_gate")].shape == \
        (port.cfg.n_units, E, d, f)
    # AdamW state both ways
    opt = tadamw.init_state(sd)
    opt["m"] = {k: torch.full_like(v, 0.5) for k, v in opt["m"].items()}
    tree = adamw_state_to_jax(opt, P)
    again = adamw_state_from_jax(tree)
    assert again["m"].keys() == opt["m"].keys()
    for k in opt["m"]:
        assert torch.equal(again["m"][k], opt["m"][k])
        assert torch.equal(again["v"][k], opt["v"][k])


def test_active_param_count_matches_reference_for_every_config(jx):
    """Every config's count equals the reference's (declarations only, no
    allocation), the encoder-decoder's too."""
    counted = []
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jx.get_config(arch)
        if cfg.is_encdec:
            for count in ("param_count", "active_param_count"):
                assert getattr(tsteps, count)(cfg) == \
                    getattr(jx.steps, count)(jcfg) == 278_301_696, arch
            counted.append(cfg.name)
            continue
        assert tsteps.param_count(cfg) == jx.steps.param_count(jcfg), arch
        assert tsteps.active_param_count(cfg) == \
            jx.steps.active_param_count(jcfg), arch
        counted.append(cfg.name)
    assert {OLMOE, LLAMA4, "qwen3-1.7b", "internvl2-26b", "rwkv6-3b",
            "jamba-v0.1-52b", "whisper-small"} <= set(counted)
    assert len(counted) == 10
    rwkv, jamba = get_config("rwkv6-3b"), get_config("jamba-v0.1-52b")
    assert tsteps.param_count(rwkv) == \
        tsteps.active_param_count(rwkv) == 3_073_313_280
    assert tsteps.param_count(jamba) == 51_570_315_264
    assert tsteps.active_param_count(jamba) == 12_110_303_232
    assert tsteps.param_count(dataclasses.replace(jamba, n_layers=8)) == \
        13_295_235_072
    olmoe = get_config(OLMOE)
    assert tsteps.param_count(olmoe) == 6_919_100_416
    assert tsteps.active_param_count(olmoe) == 1_281_955_840
    assert tsteps.param_count(dataclasses.replace(olmoe, n_layers=4)) == \
        1_884_310_528


def test_launchers_serve_and_train_olmoe_on_cpu(tmp_path, capsys):
    done = serve_launch.main(["--arch", OLMOE, "--reduced", "--requests",
                              "3", "--batch", "2", "--prompt-len", "5",
                              "--new-tokens", "3", "--max-len", "16",
                              "--device", "cpu", "--moe-dispatch", "dense"])
    assert [r.out_tokens.shape for r in done] == [(3,)] * 3
    assert "served 3 requests on cpu" in capsys.readouterr().out
    prog, params, opt, hist = train_launch.main(
        ["--arch", OLMOE, "--reduced", "--steps", "2", "--batch", "2",
         "--seq", "8", "--device", "cpu", "--moe-dispatch", "dense",
         "--ckpt-every", "0", "--ckpt-dir", str(tmp_path)])
    assert prog.model.moe_dispatch == "dense"
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite([h["loss"], h["moe_lb"], h["moe_z"]]).all()
               for h in hist)
    prog, _, _, _ = train_launch.main(
        ["--arch", OLMOE, "--reduced", "--steps", "1", "--batch", "2",
         "--seq", "8", "--device", "cpu", "--n-layers", "4",
         "--ckpt-every", "0", "--ckpt-dir", str(tmp_path)])
    assert prog.model.cfg.n_layers == 4 and len(prog.model.layers) == 4
    assert prog.model.moe_dispatch == "fused"


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_dispatch_is_bitwise_on_repeat(cuda_device):
    cfg = dataclasses.replace(get_config(OLMOE), n_layers=1)
    m = cfg.moe
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(4, 512, cfg.d_model, generator=gen, device=cuda_device) \
        .to(torch.bfloat16)
    p = {"router": 0.02 * torch.randn(cfg.d_model, m.n_experts,
                                      generator=gen, device=cuda_device),
         **{k: (0.05 * torch.randn(s, generator=gen, device=cuda_device))
            .to(torch.bfloat16) for k, s in (
                ("w_gate", (m.n_experts, cfg.d_model, m.d_expert)),
                ("w_up", (m.n_experts, cfg.d_model, m.d_expert)),
                ("w_down", (m.n_experts, m.d_expert, cfg.d_model)))}}
    outs = [tmoe.moe_fwd(p, x, cfg, "fused") for _ in range(2)]
    assert bool(torch.isfinite(outs[0][0]).all())
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(outs[0][1][k], outs[1][1][k])
               for k in outs[0][1])


@pytest.mark.cuda
def test_cuda_reduced_training_is_bitwise(cuda_device, tmp_path):
    def run(tag):
        prog = tsteps.make_train_step(get_config(OLMOE).reduce(), _shape(),
                                      ocfg=tadamw.AdamWConfig(**OCFG),
                                      microbatches=1)
        return run_training(
            TrainLoopConfig(total_steps=3, ckpt_dir=str(tmp_path / tag),
                            ckpt_every=0),
            prog, _data_cfg(),
            lambda: prog.model.init(
                torch.Generator(device=cuda_device).manual_seed(0)),
            log=None)

    p_a, _, h_a = run("a")
    p_a = {k: v.detach().clone() for k, v in p_a.items()}
    p_b, _, h_b = run("b")
    assert [(h["loss"], h["grad_norm"]) for h in h_a] == \
        [(h["loss"], h["grad_norm"]) for h in h_b]
    for name, p in p_b.items():
        assert torch.equal(p, p_a[name]), name
