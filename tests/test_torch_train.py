"""The port's training path against the JAX package.

Same numpy inputs and the same weights (the reference LM's params carried
over by ``convert.lm_params_from_jax``) through the JAX function and its
counterpart in the port, on ``get_config("qwen3-1.7b").reduce()`` (f32,
``remat=False``, one case with ``remat=True``):

* ``cross_entropy`` with ignored labels and a mask: rtol 1e-6;
* ``LM.loss_fn`` (rtol 1e-5) and the gradient of every leaf against
  ``jax.value_and_grad``: rtol 1e-5 plus 2e-6 of the leaf's largest
  |grad| (float32 sums in other orders: the q_norm / k_norm / wk leaves
  hold elements 0.3 % of their leaf's largest that come out of 128-term
  sums which cancel, and differ by up to 1.3e-6 of it);
* the CPU ``blocked_attention``'s dq / dk / dv against ``jax.grad`` of
  the reference's, G = 2, causal and full, L = 64: 1e-5 of max |grad|;
* ``adamw.update`` for 3 steps with clipping active and inactive, and
  ``schedule`` at step 0, in warmup, mid-decay and past the end: rtol 1e-6
  (float32 ops in the reference's order), plus 1e-7 of the leaf's largest
  value where ``b1 * m`` and ``(1 - b1) * g`` cancel (the global norm's
  sums, taken in another order, move the clip scale by an ulp);
* ``SyntheticStream`` bitwise, steps 0-5 and after ``from_state``;
* ``make_train_step`` at 1 and 2 microbatches, 2 steps: metrics rtol
  1e-5, params rtol 1e-5 plus 1e-2 of the peak learning rate (AdamW moves
  an element by lr * m / (sqrt(v) + eps): where its gradient is of the
  order of eps, 1e-9 here, a float32 residue of sums that cancel, the two
  packages' residues differ by percents and so do the updates; measured
  up to 0.65 % of lr over six steps);
* ``run_training`` killed by ``fail_at_step`` and resumed, bitwise equal
  to an uninterrupted run; the loss falls as in
  ``tests/test_fault_tolerance.py``; a checkpoint of the reference's
  ``run_training`` resumed by the port's and the reverse: the resumed
  step's loss within 1e-6 of the writer's own (the same parameters), the
  losses within 1e-5 of the resumer's uninterrupted run and the
  parameters as above;
* the serving cache of cast weights never reaches a gradient (a loss after
  ``prefill`` has the gradients of a fresh model).

JAX is imported only inside fixtures (``pytest.importorskip``); the
``cuda`` cases hold B7b (``flash_attention_backward``) against its plain
form and itself, and the embedding gradient against itself, on the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import build_model, get_config
from repro_torch.configs import SHAPES
from repro_torch.convert import (adamw_state_from_jax, adamw_state_to_jax,
                                 lm_params_from_jax, lm_params_to_jax)
from repro_torch.data.synthetic import DataConfig, SyntheticStream
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (FlashAttentionFunction,
                                                 flash_attention,
                                                 flash_attention_backward,
                                                 flash_attention_backward_plain)
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as train_launch
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime.train_loop import TrainLoopConfig, run_training

ARCH = "qwen3-1.7b"
SEQ, BATCH = 16, 4
OCFG = dict(lr=8e-3, warmup_steps=2, total_steps=60)
PARAM_ATOL = 1e-2 * OCFG["lr"]     # see the module docstring


class Jax:
    """The reference package's training pieces (imported only where JAX
    is), with its train programs jitted once per microbatch count."""

    def __init__(self):
        pytest.importorskip("jax")
        import jax
        import jax.numpy as jnp
        from repro.configs import SHAPES as JSHAPES
        from repro.configs import get_config as jax_get_config
        from repro.data import synthetic
        from repro.launch.mesh import make_mesh
        from repro.launch import steps
        from repro.models import attention, build_model as jax_build_model
        from repro.models import layers
        from repro.optim import adamw
        from repro.parallel.sharding import ShardingCtx
        from repro.runtime import train_loop
        self.jax, self.jnp = jax, jnp
        self.attention, self.layers, self.adamw = attention, layers, adamw
        self.synthetic, self.steps, self.train_loop = \
            synthetic, steps, train_loop
        self.get_config, self.build_model = jax_get_config, jax_build_model
        self.shapes, self.make_mesh = JSHAPES, make_mesh
        self.ctx = ShardingCtx(mesh=make_mesh((1, 1), ("data", "model")),
                               batch_axes=("data",))
        self._progs = {}

    def cfg(self, **kw):
        return dataclasses.replace(self.get_config(ARCH).reduce(), **kw)

    def model(self, seed=0, **kw):
        model = self.build_model(self.cfg(**kw), self.ctx)
        return model, model.init(self.jax.random.PRNGKey(seed))

    def program(self, mb):
        if mb not in self._progs:
            cfg = self.cfg()
            shape = dataclasses.replace(self.shapes["train_4k"],
                                        seq_len=SEQ, global_batch=BATCH)
            ctx = self.steps.make_ctx(cfg, shape, self.ctx.mesh, fsdp=False)
            self._progs[mb] = self.steps.make_train_step(
                cfg, shape, ctx, ocfg=self.adamw.AdamWConfig(**OCFG),
                microbatches=mb, donate=False)
        return self._progs[mb]


@pytest.fixture(scope="module")
def jx():
    return Jax()


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _port_cfg(**kw):
    return dataclasses.replace(get_config(ARCH).reduce(), **kw)


def _port_model(jax_params, **kw):
    model = build_model(_port_cfg(**kw), device="cpu")
    model.load_state_dict(lm_params_from_jax(_np(jax_params)))
    return model


def _port_program(mb=1):
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=SEQ,
                                global_batch=BATCH)
    return tsteps.make_train_step(_port_cfg(), shape,
                                  ocfg=tadamw.AdamWConfig(**OCFG),
                                  microbatches=mb, device="cpu")


def _data_cfg(**kw):
    return DataConfig(**dict(dict(vocab=512, seq_len=SEQ,
                                  global_batch=BATCH, seed=11), **kw))


def _close(got, want, rtol, atol_of_max):
    want = np.asarray(want, np.float64)
    got = np.asarray(torch.as_tensor(got).detach().double())
    atol = atol_of_max * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# ---- the loss ------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(jx, masked):
    rng = np.random.RandomState(3)
    logits = (3 * rng.randn(3, 7, 50)).astype(np.float32)
    labels = rng.randint(-1, 50, size=(3, 7)).astype(np.int32)
    labels[0, :3] = -5                       # ignored
    mask = rng.rand(3, 7) < 0.6 if masked else None
    want = float(jx.layers.cross_entropy(
        jx.jnp.asarray(logits), jx.jnp.asarray(labels),
        None if mask is None else jx.jnp.asarray(mask)))
    got = tlayers.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels),
                                None if mask is None else
                                torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_cross_entropy_of_no_valid_label_is_zero():
    logits = torch.randn(2, 3, 10)
    labels = torch.full((2, 3), -1)
    assert float(tlayers.cross_entropy(logits, labels)) == 0.0


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_match_reference(jx, remat):
    model, params = jx.model(seed=1, remat=remat)
    port = _port_model(params, remat=remat)
    tokens = np.random.RandomState(5).randint(0, 512, (2, 17)) \
        .astype(np.int32)
    (loss, metrics), grads = jx.jax.value_and_grad(
        model.loss_fn, has_aux=True)(params, {"tokens": jx.jnp.asarray(tokens)})
    got, got_m = port.loss_fn({"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    assert set(got_m) == set(metrics) == {"ce"}
    got.backward()
    want = lm_params_from_jax(_np(grads))
    names = [n for n, _ in port.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, p in port.named_parameters():
        assert p.grad is not None and bool(p.grad.abs().max() > 0), name
        _close(p.grad, want[name].numpy(), 1e-5, 2e-6)


def test_loss_fn_refuses_prefix_embeds():
    port = build_model(_port_cfg(), device="cpu").init(
        torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="ROADMAP A14: VLM"):
        port.loss_fn({"tokens": torch.zeros((1, 5), dtype=torch.int32),
                      "prefix_embeds": torch.zeros((1, 2, 64))})


def test_loss_after_prefill_gets_a_fresh_model_s_gradients():
    """The serving path's cast copies (bf16 compute over f32 params) carry
    no autograd history: a loss after a prefill must not use them."""
    cfg = _port_cfg(compute_dtype="bfloat16")
    gen = torch.Generator().manual_seed(2)
    served = build_model(cfg, device="cpu").init(gen)
    fresh = build_model(cfg, device="cpu")
    fresh.load_state_dict(served.state_dict())
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, 512, (2, 9)).astype(np.int32))
    served.prefill({"tokens": tokens[:, :-1]})
    assert served._cast is not None
    for model in (served, fresh):
        model.loss_fn({"tokens": tokens})[0].backward()
    for (name, a), (_, b) in zip(served.named_parameters(),
                                 fresh.named_parameters()):
        assert a.grad is not None, name
        assert torch.equal(a.grad, b.grad), name
        if name.startswith("layers.") and "norm" not in name:
            assert bool(a.grad.abs().max() > 0), name
    # an in-place step leaves the serving copies stale: drop_cast clears
    # them and the next prefill casts the new weights
    with torch.no_grad():
        served.lm_head.mul_(2)
    served.drop_cast()
    assert served._cast is None
    served.prefill({"tokens": tokens})
    assert torch.equal(served._cast[1], served.lm_head.to(torch.bfloat16))


@pytest.mark.parametrize("causal", [True, False])
def test_blocked_attention_gradients_match_reference(jx, causal):
    rng = np.random.RandomState(9)
    q = rng.randn(2, 64, 4, 16).astype(np.float32)
    k = rng.randn(2, 64, 2, 16).astype(np.float32)
    v = rng.randn(2, 64, 2, 16).astype(np.float32)
    w = rng.randn(2, 64, 4, 16).astype(np.float32)

    def jloss(q, k, v):
        out = jx.attention.blocked_attention(q, k, v, causal=causal,
                                             q_chunk=32, kv_chunk=16)
        return (out * w).sum()

    want = jx.jax.grad(jloss, argnums=(0, 1, 2))(
        *map(jx.jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tattn.blocked_attention(qt, kt, vt, causal=causal, q_chunk=32,
                                  kv_chunk=16)
    (out * torch.from_numpy(w)).sum().backward()
    for got, exp in zip((qt.grad, kt.grad, vt.grad), want):
        _close(got, np.asarray(exp), 0, 1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_plain_form_matches_f64_oracle(causal):
    g = torch.Generator().manual_seed(4)
    q = torch.randn(3, 40, 2, 16, generator=g)
    k, v = torch.randn(3, 40, 16, generator=g), \
        torch.randn(3, 40, 16, generator=g)
    dout = torch.randn(3, 40, 2, 16, generator=g)
    out = flash_attention(q, k, v, causal=causal)
    lse = torch.zeros(q.shape[:3])
    got = flash_attention_backward(q, k, v, out, dout, lse, causal=causal)
    want = ref.flash_attention_backward_ref(q, k, v, dout, causal=causal)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        _close(a, b.numpy(), 0, 2e-5)
    # autograd through flash_attention on the CPU is the same plain form
    qq = q.clone().requires_grad_()
    flash_attention(qq, k, v, causal=causal).backward(dout)
    assert torch.equal(qq.grad, got[0])


def test_flash_backward_refuses_what_the_kernel_does_not_take():
    q, k, v = torch.randn(1, 8, 2, 16), torch.randn(1, 8, 16), \
        torch.randn(1, 8, 16)
    out, lse = torch.randn(1, 8, 2, 16), torch.zeros(1, 8, 2)
    with pytest.raises(ValueError, match="dout must be"):
        flash_attention_backward(q, k, v, out, torch.randn(1, 8, 2, 32), lse)
    with pytest.raises(ValueError, match="lse must be"):
        flash_attention_backward(q, k, v, out, out, torch.zeros(1, 8))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_backward(q, k, v, out,
                                 torch.randn(1, 2, 8, 16).transpose(1, 2),
                                 lse)


# ---- optimizer and data ----------------------------------------------------------

@pytest.mark.parametrize("step", [0, 3, 30, 80])
def test_schedule_matches_reference(jx, step):
    ocfg = dict(lr=3e-3, warmup_steps=10, total_steps=50)
    want = float(jx.adamw.schedule(jx.adamw.AdamWConfig(**ocfg),
                                   jx.jnp.asarray(step, jx.jnp.int32)))
    got = tadamw.schedule(tadamw.AdamWConfig(**ocfg),
                          torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("clip", [0.05, 100.0])
def test_adamw_update_matches_reference(jx, clip):
    rng = np.random.RandomState(6)
    shapes = {"a": (7, 5), "b": (11,), "c": (3, 2, 4)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip)
    jcfg, tcfg = jx.adamw.AdamWConfig(**ocfg), tadamw.AdamWConfig(**ocfg)
    jp = {k: jx.jnp.asarray(v) for k, v in params.items()}
    js = jx.adamw.init_state(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = tadamw.init_state(tp)
    for _ in range(3):
        grads = {k: rng.randn(*s).astype(np.float32)
                 for k, s in shapes.items()}
        jp, js, jm = jx.adamw.update(
            jcfg, jp, {k: jx.jnp.asarray(v) for k, v in grads.items()}, js)
        tp, ts, tm = tadamw.update(
            tcfg, tp, {k: torch.from_numpy(v) for k, v in grads.items()}, ts)
        clipped = float(jm["grad_norm"]) > clip
        assert clipped == (clip < 1)
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-6)
        assert int(ts["step"]) == int(js["step"])
        for k in shapes:
            for got, want in ((tp[k], jp[k]), (ts["m"][k], js["m"][k]),
                              (ts["v"][k], js["v"][k])):
                _close(got, np.asarray(want), 1e-6, 1e-7)


def test_synthetic_stream_is_the_reference_s(jx):
    cfg = dict(vocab=512, seq_len=SEQ, global_batch=BATCH, seed=11,
               copy_period=4)
    ours = SyntheticStream(DataConfig(**cfg))
    theirs = jx.synthetic.SyntheticStream(jx.synthetic.DataConfig(**cfg))
    try:
        for _ in range(6):
            a, b = ours.next(), theirs.next()
            assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
        state = ours.state()
        assert state == theirs.state() == {"step": 6}
    finally:
        ours.close()
        theirs.close()
    resumed = SyntheticStream.from_state(DataConfig(**cfg), {"step": 3})
    try:
        for step in range(3, 6):
            assert np.array_equal(resumed.next(), jx.synthetic._batch_at(
                jx.synthetic.DataConfig(**cfg), step))
    finally:
        resumed.close()


# ---- the train step, the loop, checkpoints --------------------------------------

def test_param_count_and_microbatches_match_reference(jx):
    for arch in ("qwen3-1.7b", "starcoder2-7b", "mistral-nemo-12b"):
        assert tsteps.param_count(get_config(arch)) == \
            jx.steps.param_count(jx.get_config(arch))
    assert tsteps.param_count(get_config(ARCH)) == 2_031_739_904
    cfg = get_config(ARCH)
    for seq, batch in ((1024, 4), (4096, 256), (4096, 1)):
        shape = dataclasses.replace(SHAPES["train_4k"], seq_len=seq,
                                    global_batch=batch)
        jshape = dataclasses.replace(jx.shapes["train_4k"], seq_len=seq,
                                     global_batch=batch)
        want = jx.steps.auto_microbatches(jx.get_config(ARCH), jshape, jx.ctx)
        assert tsteps.auto_microbatches(cfg, shape) == want


@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_matches_reference(jx, mb):
    jprog = jx.program(mb)
    _, params = jx.model(seed=0)
    prog = _port_program(mb)
    prog.model.load_state_dict(lm_params_from_jax(_np(params)))
    tparams = prog.params
    topt = tadamw.init_state(tparams)
    jopt = jx.adamw.init_state(params)
    data = _data_cfg()
    for step in range(2):
        from repro_torch.data.synthetic import _batch_at
        batch = _batch_at(data, step)
        params, jopt, jm = jprog.step_fn(params, jopt,
                                         {"tokens": jx.jnp.asarray(batch)})
        tparams, topt, tm = prog.step_fn(tparams, topt,
                                         {"tokens": torch.from_numpy(batch)})
        assert set(tm) == set(jm) == {"loss", "ce", "grad_norm", "lr"}
        for name in tm:
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-5)
    want = lm_params_from_jax(_np(params))
    for name, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=PARAM_ATOL)
    back = adamw_state_to_jax(topt, 1)
    assert int(back["step"]) == int(jopt["step"]) == 2
    assert _np(back["v"]).keys() == _np(jopt["v"]).keys()


def _jax_init(jx):
    _, params = jx.model(seed=0)
    return lambda: lm_params_from_jax(_np(params))


def test_kill_and_resume_is_bitwise(jx, tmp_path):
    init = _jax_init(jx)
    loop = TrainLoopConfig(total_steps=6, ckpt_dir=str(tmp_path / "a"),
                           ckpt_every=2, log_every=100)
    prog = _port_program()
    p_ref, o_ref, ref_hist = run_training(loop, prog, _data_cfg(), init,
                                          log=None)
    p_ref = {k: v.detach().clone() for k, v in p_ref.items()}
    loop2 = dataclasses.replace(loop, ckpt_dir=str(tmp_path / "b"))
    prog2 = _port_program()
    with pytest.raises(RuntimeError, match="injected failure"):
        run_training(loop2, prog2, _data_cfg(), init, fail_at_step=3,
                     log=None)
    prog3 = _port_program()
    params, opt, hist = run_training(loop2, prog3, _data_cfg(), init,
                                     log=None)
    assert [h["step"] for h in hist] == [2, 3, 4, 5]
    by_step = {h["step"]: h for h in ref_hist}
    for h in hist:
        assert h["loss"] == by_step[h["step"]]["loss"], h
        assert h["grad_norm"] == by_step[h["step"]]["grad_norm"], h
    for name, p in params.items():
        assert torch.equal(p, p_ref[name]), name
    assert int(opt["step"]) == int(o_ref["step"]) == 6
    for k in opt["m"]:
        assert torch.equal(opt["m"][k], o_ref["m"][k])
        assert torch.equal(opt["v"][k], o_ref["v"][k])


def test_loss_decreases(jx, tmp_path):
    # the reference's easily-learnable stream (small effective vocab,
    # period-1 motif) and its bar: the last five steps' mean loss 0.5
    # under the first five's within 60 steps
    data = _data_cfg(vocab=64, copy_period=1)
    loop = TrainLoopConfig(total_steps=60, ckpt_dir=str(tmp_path / "c"),
                           ckpt_every=100, log_every=100)
    _, _, hist = run_training(loop, _port_program(), data, _jax_init(jx),
                              log=None)
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.5, (first, last)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_between_packages(jx, tmp_path, writer):
    """One package runs 4 steps (a checkpoint at 3, killed after 4), the
    other resumes from step 3 to 6."""
    init = _jax_init(jx)
    jprog = jx.program(1)
    data = _data_cfg()
    jdata = jx.synthetic.DataConfig(**dataclasses.asdict(data))
    kw = dict(total_steps=6, ckpt_every=3, log_every=100)
    run_j = lambda d, **k: jx.train_loop.run_training(  # noqa: E731
        jx.train_loop.TrainLoopConfig(ckpt_dir=str(d), **kw), jprog, jdata,
        lambda: jx.model(seed=0)[1], log=None, **k)
    run_t = lambda d, **k: run_training(  # noqa: E731
        TrainLoopConfig(ckpt_dir=str(d), **kw), _port_program(), data, init,
        log=None, **k)
    first, second = (run_j, run_t) if writer == "reference" else \
        (run_t, run_j)
    with pytest.raises(RuntimeError, match="injected failure"):
        first(tmp_path / "x", fail_at_step=4)
    params, _, hist = second(tmp_path / "x")
    assert [h["step"] for h in hist] == [3, 4, 5]
    _, _, writer_hist = first(tmp_path / "w")
    np.testing.assert_allclose(hist[0]["loss"], writer_hist[3]["loss"],
                               rtol=1e-6)
    want_params, _, want_hist = second(tmp_path / "y")
    for h, w in zip(hist, want_hist[3:]):
        np.testing.assert_allclose(h["loss"], w["loss"], rtol=1e-5)
    if writer == "port":         # the reference resumed: JAX trees
        params, want_params = (lm_params_from_jax(_np(p))
                               for p in (params, want_params))
    for name, p in params.items():
        np.testing.assert_allclose(
            np.asarray(torch.as_tensor(p).detach()),
            np.asarray(torch.as_tensor(want_params[name]).detach()),
            rtol=1e-5, atol=PARAM_ATOL)


def test_checkpoint_tree_is_the_reference_s(tmp_path):
    prog = _port_program()
    prog.model.init(torch.Generator().manual_seed(3))
    opt = tadamw.init_state(prog.params)
    tree = {"params": lm_params_to_jax(prog.params, 1),
            "opt": adamw_state_to_jax(opt, 1)}
    from repro_torch.ckpt.checkpoint import _flat
    flat = _flat(tree)
    abstract = _flat({"params": prog.abstract_params,
                      "opt": prog.abstract_opt})
    assert flat.keys() == abstract.keys()
    for k, t in flat.items():
        assert tuple(t.shape) == tuple(abstract[k].shape), k
        assert t.dtype == abstract[k].dtype, k
    back = adamw_state_from_jax(tree["opt"])
    assert back["step"].dtype == torch.int32 and back["m"].keys() == \
        opt["m"].keys()


def test_train_launcher_runs_and_resumes_on_cpu(tmp_path, capsys):
    argv = ["--arch", ARCH, "--reduced", "--steps", "4", "--batch", "2",
            "--seq", "8", "--ckpt-every", "2", "--ckpt-dir",
            str(tmp_path / "run"), "--device", "cpu"]
    with pytest.raises(RuntimeError, match="injected failure"):
        train_launch.main(argv + ["--fail-at-step", "3"])
    _, _, _, hist = train_launch.main(argv)
    assert [h["step"] for h in hist] == [2, 3]
    out = capsys.readouterr().out
    assert "[resume] step 2 from checkpoint 2" in out
    _, _, _, fresh = train_launch.main(
        argv[:-3] + [str(tmp_path / "fresh"), "--device", "cpu"])
    assert [h["loss"] for h in fresh[2:]] == [h["loss"] for h in hist]


def test_ckpt_every_zero_writes_no_checkpoint(tmp_path):
    loop = TrainLoopConfig(total_steps=3, ckpt_dir=str(tmp_path / "none"),
                           ckpt_every=0)
    prog = _port_program()
    _, opt, hist = run_training(
        loop, prog, _data_cfg(),
        lambda: prog.model.init(torch.Generator().manual_seed(0)), log=None)
    assert [h["step"] for h in hist] == [0, 1, 2] and int(opt["step"]) == 3
    assert list((tmp_path / "none").iterdir()) == []


def test_training_entry_points_default_to_cuda():
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=8,
                                global_batch=2)
    if torch.cuda.is_available():
        assert tsteps.make_train_step(_port_cfg(), shape).model.device.type \
            == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        tsteps.make_train_step(_port_cfg(), shape)
    with pytest.raises(RuntimeError, match="cuda"):
        train_launch.main(["--arch", ARCH, "--reduced", "--steps", "1"])
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        tsteps.make_train_step(_port_cfg(), shape, zero2=True, device="cpu")


# ---- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


CUDA_BWD = [(4, 128, 128, 2, 128, True), (3, 100, 100, 2, 64, True),
            (2, 70, 70, 4, 32, False), (2, 33, 90, 1, 16, False),
            (2, 65, 65, 3, 16, True), (1, 200, 200, 1, 128, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,l,s,g,hd,causal", CUDA_BWD)
def test_b7b_matches_plain_backward_and_repeats_bitwise(cuda_device, dtype,
                                                        bh, l, s, g, hd,
                                                        causal):
    """The Function's dq / dk / dv against the plain backward (2e-5 of max
    |grad| in f32, 2e-2 in bf16: p and the outputs rounded to bf16 at
    other points), and a second launch bitwise equal to the first."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(l + s + hd)
    q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda").to(dt)
                     for shape in ((bh, l, g, hd), (bh, s, hd), (bh, s, hd),
                                   (bh, l, g, hd)))
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    before = flash_attention_backward.launches
    out = flash_attention(qq, kk, vv, causal=causal)
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    out.backward(dout)
    assert flash_attention_backward.launches == before + 1
    want = flash_attention_backward_plain(q, k, v, dout, causal=causal)
    tol = 2e-5 if dtype == "float32" else 2e-2
    for got, exp in zip((qq.grad, kk.grad, vv.grad), want):
        assert got.dtype == dt
        _close(got.cpu(), exp.double().cpu().numpy(), 0, tol)
    again = FlashAttentionFunction.apply(qq, kk, vv, causal)
    grads = torch.autograd.grad(again, (qq, kk, vv), dout)
    for a, b in zip(grads, (qq.grad, kk.grad, vv.grad)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_embedding_gradient_repeats_bitwise_on_the_card(cuda_device):
    cfg = _port_cfg()
    model = build_model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, 8, (4, 257), device="cuda")   # many repeats
    grads = []
    for _ in range(2):
        model.zero_grad()
        model.loss_fn({"tokens": tokens})[0].backward()
        grads.append(model.embed.grad.clone())
    assert torch.equal(grads[0], grads[1])
