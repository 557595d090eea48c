"""The port's VLM prefix (internvl2-26b) against the JAX package.

Same numpy inputs and the same weights (the reference ``LM``'s params
carried over by ``convert.lm_params_from_jax``) through the JAX function
and its counterpart in the port, on ``get_config("internvl2-26b")
.reduce()`` (d 64, 2 layers, 4 q heads over 2 kv heads of 16, vocab 512,
a prefix of P = 8 rows, f32) with the reference's one-device ``("data",
"model")`` mesh.  The weights are the reference's ``init`` with every
stacked layer matrix rescaled to ``1 / sqrt(fan_in)``, as
``tests/test_torch_encdec.py`` draws whisper's: at the reference's own
scale (``1 / sqrt(n_units)`` = 0.71 at two layers, against 0.125 at fan-in
64; the model has no qk_norm) float32 cannot hold two summation orders
together (measured against a float64 run of the port on the same weights
and inputs: gradients up to 2.3e-5 (port) and 2.6e-5 (reference) of a
leaf's max with the prefix, 6.0e-5 and 1.3e-4 without; at fan-in scale
1.0e-6 and 1.4e-6):

* ``loss_fn`` with a prefix: the loss and ``ce`` at rtol 1e-5, and every
  gradient leaf at rtol 1e-5 plus 2e-6 of the leaf's max
  (``tests/test_torch_train.py``'s bar), remat off and on;
* ``prefill`` with a prefix, without and with a cache (logits and every
  cache leaf within 1e-5 of their max), then four decode steps from slot
  P + L against the reference's;
* the reference smoke test's decode check inside the port: a cached
  prefill of L - 1 tokens after the prefix, then a decode step at slot
  P + L - 1, equal to a no-cache prefill of all L tokens;
* one ``make_train_step`` step with ``prefix_embeds`` at one and two
  microbatches (the prefix split with the tokens): metrics rtol 1e-5,
  parameters rtol 1e-5 plus 2e-2 of lr (that file's AdamW bar, 1e-2,
  doubled for one residue-gradient element: see ``PARAM_ATOL``);
* ``make_prefill_step`` / ``make_decode_step`` (bfloat16 weights) with a
  bfloat16 prefix against the reference's builders, decode from P + L;
* the prefix is rounded to the compute dtype before the concat (bfloat16
  compute: a float32 prefix gives the bits of its bfloat16 rounding);
* four steps of ``run_training`` with a prefix (``batch_to_inputs``)
  give the reference's losses (rtol 1e-5);
* the text-only paths: a greedy ``BatchServer`` wave's tokens equal the
  reference's, and both launchers run the config on tokens alone;
* the converter's names and bits, ``param_count`` of the full config.

JAX is imported only inside a fixture (``pytest.importorskip``), its
programs compiled once per module; the ``cuda`` cases run the reduced
model with a prefix on the card (B7 at G = 2, B7b) against the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import BatchServer, build_model, get_config
from repro_torch.configs import SHAPES
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax
from repro_torch.data.synthetic import DataConfig
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_backward)
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as train_launch
from repro_torch.models.transformer import LM
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime.serve_loop import Request
from repro_torch.runtime.train_loop import TrainLoopConfig, run_training
from _torch_threads import share_cores  # noqa: E402

ARCH = "internvl2-26b"
F32_TOL = 1e-5
GRAD_TOL = 2e-6            # of a leaf's max, beside rtol 1e-5
B, L, P, D = 2, 9, 8, 64   # batch, text, the reduced prefix, d_model
MAX_LEN = 24               # P + L + decode steps
OCFG = dict(lr=8e-3, warmup_steps=2, total_steps=60)
# parameters after one AdamW step: tests/test_torch_train.py's rtol 1e-5
# plus, here, 2e-2 of lr (that file's 1e-2 measured 0.65 % on qwen3; here
# one element of layers.1.mlp.w_gate at two microbatches sits 1.49e-2 of
# lr apart: its gradient, -8.2e-9, is a float32 residue of sums that
# cancel, and AdamW's first step moves it by lr * g / (|g| + eps))
PARAM_ATOL = 2e-2 * OCFG["lr"]


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """Run this module's PyTorch ops on the worker's share of the cores."""
    yield from share_cores()


class Jax:
    """The reference package's LM pieces, each jitted program built once
    for the module."""

    def __init__(self):
        pytest.importorskip("jax")
        import jax
        import jax.numpy as jnp
        from repro.configs import SHAPES as JSHAPES
        from repro.configs import get_config as jax_get_config
        from repro.data import synthetic
        from repro.launch import steps
        from repro.launch.mesh import make_mesh
        from repro.models import build_model as jax_build_model
        from repro.optim import adamw
        from repro.parallel.sharding import ShardingCtx
        from repro.runtime import serve_loop, train_loop
        self.jax, self.jnp = jax, jnp
        self.steps, self.adamw, self.shapes = steps, adamw, JSHAPES
        self.synthetic, self.serve_loop, self.train_loop = \
            synthetic, serve_loop, train_loop
        self.get_config, self.build_model = jax_get_config, jax_build_model
        self.ctx = ShardingCtx(mesh=make_mesh((1, 1), ("data", "model")),
                               batch_axes=("data",))
        self.cfg = jax_get_config(ARCH).reduce()
        self.model = jax_build_model(self.cfg, self.ctx)
        self.params = jax.tree.map(jnp.asarray, _at_fan_in(_np(
            jax.jit(self.model.init)(jax.random.PRNGKey(1)))))
        self._jit = {}

    def jit(self, key, make):
        if key not in self._jit:
            self._jit[key] = make()
        return self._jit[key]

    def prefill(self):
        return self.jit("prefill", lambda: self.jax.jit(self.model.prefill))

    def decode(self):
        return self.jit("decode",
                        lambda: self.jax.jit(self.model.decode_step))

    def program(self, mb, shape):
        return self.jit(("train", mb, shape.seq_len, shape.global_batch),
                        lambda: self.steps.make_train_step(
                            self.cfg, shape,
                            self.steps.make_ctx(self.cfg, shape,
                                                self.ctx.mesh, fsdp=False),
                            ocfg=self.adamw.AdamWConfig(**OCFG),
                            microbatches=mb, donate=False))


@pytest.fixture(scope="module")
def jx():
    return Jax()


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _at_fan_in(params):
    """The reference's params (numpy) with every stacked layer matrix
    ``(n, fan_in, out)`` rescaled from ``1 / sqrt(n)`` to ``1 /
    sqrt(fan_in)`` (see the module docstring); in its dtype."""
    def walk(tree, stacked):
        return {k: walk(v, stacked or k == "units")
                if isinstance(v, dict) else
                (v.astype(np.float32) * np.float32(
                    (v.shape[0] / v.shape[1]) ** 0.5)).astype(v.dtype)
                if stacked and v.ndim == 3 else v
                for k, v in tree.items()}
    return walk(params, False)


def _port_cfg(**kw):
    return dataclasses.replace(get_config(ARCH).reduce(), **kw)


def _port_model(jx, **kw):
    model = build_model(_port_cfg(**kw), device="cpu")
    model.load_state_dict(lm_params_from_jax(_np(jx.params)))
    return model


def _rel(want, got):
    want = np.asarray(want, np.float64)
    got = np.asarray(torch.as_tensor(got).detach().double())
    assert want.shape == got.shape, (want.shape, got.shape)
    return np.abs(want - got).max() / max(np.abs(want).max(), 1e-30)


def _close(got, want, rtol, atol_of_max):
    want = np.asarray(want, np.float64)
    got = np.asarray(torch.as_tensor(got).detach().double())
    atol = atol_of_max * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _inputs(seed=0, batch=B, text=L):
    """(prefix (batch, P, d) f32, tokens (batch, text) int32)."""
    rng = np.random.RandomState(seed)
    prefix = rng.randn(batch, P, D).astype(np.float32)
    tokens = rng.randint(0, 512, (batch, text)).astype(np.int32)
    return prefix, tokens


def _batch(prefix, tokens, lib):
    if lib == "jax":
        import jax.numpy as jnp
        return {"prefix_embeds": jnp.asarray(prefix),
                "tokens": jnp.asarray(tokens)}
    return {"prefix_embeds": torch.from_numpy(prefix),
            "tokens": torch.from_numpy(tokens)}


# ---- loss and gradients ----------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True], ids=["remat-off",
                                                      "remat-on"])
def test_loss_and_every_gradient_match_reference(jx, remat):
    model = jx.build_model(dataclasses.replace(jx.cfg, remat=remat), jx.ctx)
    vg = jx.jit(("value_and_grad", remat), lambda: jx.jax.jit(
        jx.jax.value_and_grad(model.loss_fn, has_aux=True)))
    prefix, toks = _inputs(6, text=L + 1)
    (loss, metrics), grads = vg(jx.params, _batch(prefix, toks, "jax"))
    port = _port_model(jx, remat=remat)
    batch = _batch(prefix, toks, "torch")
    got, got_m = port.loss_fn(batch)
    assert set(got_m) == set(metrics) == {"ce"}
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    np.testing.assert_allclose(float(got_m["ce"].detach()),
                               float(metrics["ce"]), rtol=1e-5)
    got.backward()
    assert batch["prefix_embeds"].grad is None
    want = lm_params_from_jax(_np(grads))
    names = [n for n, _ in port.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, p in port.named_parameters():
        assert p.grad is not None and bool(p.grad.abs().max() > 0), name
        _close(p.grad, want[name].numpy(), 1e-5, GRAD_TOL)


def test_loss_drops_the_prefix_rows(jx, monkeypatch):
    """The P prefix rows leave before the logits (B, L, d) are made, and
    the text-only loss is the reference's LM without a prefix."""
    port = _port_model(jx)
    seen = []
    real = port._logits
    monkeypatch.setattr(port, "_logits",
                        lambda x: seen.append(tuple(x.shape)) or real(x))
    prefix, toks = _inputs(2, text=L + 1)
    with torch.no_grad():
        with_prefix, _ = port.loss_fn(_batch(prefix, toks, "torch"))
        text_only, _ = port.loss_fn({"tokens": torch.from_numpy(toks)})
    assert seen == [(B, L, D), (B, L, D)]
    assert float(with_prefix) != float(text_only)
    want, _ = jx.jit("loss", lambda: jx.jax.jit(jx.model.loss_fn))(
        jx.params, {"tokens": jx.jnp.asarray(toks)})
    np.testing.assert_allclose(float(text_only), float(want), rtol=1e-5)


# ---- serving -----------------------------------------------------------------------

def test_prefill_and_decode_match_reference(jx):
    prefix, toks = _inputs(4)
    port = _port_model(jx)
    prefill, decode = jx.prefill(), jx.decode()
    want, _ = prefill(jx.params, _batch(prefix, toks, "jax"))
    got, none = port.prefill(_batch(prefix, toks, "torch"))
    assert none is None and got.shape == (B, 512)
    assert _rel(want, got) <= F32_TOL
    jc = jx.model.init_cache(B, MAX_LEN)
    want, jc = prefill(jx.params, _batch(prefix, toks, "jax"), jc)
    tc = port.init_cache(B, MAX_LEN)
    got, same = port.prefill(_batch(prefix, toks, "torch"), tc)
    assert same is tc and _rel(want, got) <= F32_TOL
    for key in ("k", "v"):
        assert _rel(jc["layer0"]["attn"][key],
                    tc["layer0"]["attn"][key]) <= F32_TOL, key
    # the prefill filled P + L slots, no more
    assert bool((tc["layer0"]["attn"]["k"][:, :, P + L:] == 0).all())
    assert bool((tc["layer0"]["attn"]["k"][:, :, P + L - 1] != 0).any())
    rng = np.random.RandomState(5)
    for t in range(4):
        tok = rng.randint(0, 512, (B, 1)).astype(np.int32)
        want, jc = decode(jx.params, jx.jnp.asarray(tok),
                          jx.jnp.int32(P + L + t), jc)
        got, tc = port.decode_step(torch.from_numpy(tok), P + L + t, tc)
        assert _rel(want, got) <= F32_TOL, t
    for key in ("k", "v"):
        assert _rel(jc["layer0"]["attn"][key],
                    tc["layer0"]["attn"][key]) <= F32_TOL, key


def test_prefill_then_decode_equals_longer_prefill(jx):
    """The reference smoke test's consistency check, inside the port: a
    decode step at slot P + L - 1 after a cached prefill of the prefix and
    L - 1 tokens gives the logits of a no-cache prefill of all L (its bar,
    2e-2; f32 here)."""
    prefix, toks = _inputs(1)
    port = _port_model(jx)
    full, _ = port.prefill(_batch(prefix, toks, "torch"))
    _, cache = port.prefill(_batch(prefix, toks[:, :L - 1], "torch"),
                            port.init_cache(B, MAX_LEN))
    step, _ = port.decode_step(torch.from_numpy(toks[:, L - 1:]),
                               P + L - 1, cache)
    assert bool(torch.isfinite(step).all())
    assert float((full - step).abs().max()) < 2e-2
    assert _rel(full.numpy(), step) <= F32_TOL
    # one slot off is another position: the check would see it
    _, cache = port.prefill(_batch(prefix, toks[:, :L - 1], "torch"),
                            port.init_cache(B, MAX_LEN))
    off, _ = port.decode_step(torch.from_numpy(toks[:, L - 1:]), L - 1,
                              cache)
    assert _rel(full.numpy(), off) > 1e-3


def test_prefix_is_rounded_to_the_compute_dtype(jx):
    """bfloat16 compute: the prefix is cast before the concat, so a
    float32 prefix and its bfloat16 rounding give the same bits."""
    port = _port_model(jx, compute_dtype="bfloat16")
    prefix, toks = _inputs(3)
    a, _ = port.prefill(_batch(prefix, toks, "torch"))
    b, _ = port.prefill({"prefix_embeds": torch.from_numpy(prefix).to(
        torch.bfloat16), "tokens": torch.from_numpy(toks)})
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)


@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_with_prefix_matches_reference(jx, mb):
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=P + L - 1,
                                global_batch=4)
    jshape = dataclasses.replace(jx.shapes["train_4k"], seq_len=P + L - 1,
                                 global_batch=4)
    assert tsteps.batch_shapes(_port_cfg(), shape)["tokens"].shape == \
        (4, L)
    jprog = jx.program(mb, jshape)
    prog = tsteps.make_train_step(_port_cfg(), shape,
                                  ocfg=tadamw.AdamWConfig(**OCFG),
                                  microbatches=mb, device="cpu")
    assert prog.microbatches == jprog.microbatches == mb
    assert isinstance(prog.model, LM)
    prog.model.load_state_dict(lm_params_from_jax(_np(jx.params)))
    prefix, toks = _inputs(7, batch=4, text=L)
    params, jopt, jm = jprog.step_fn(jx.params,
                                     jx.adamw.init_state(jx.params),
                                     _batch(prefix, toks, "jax"))
    tparams, topt, tm = prog.step_fn(prog.params,
                                     tadamw.init_state(prog.params),
                                     _batch(prefix, toks, "torch"))
    assert set(tm) == set(jm) == {"loss", "ce", "grad_norm", "lr"}
    for name in tm:
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-5)
    want = lm_params_from_jax(_np(params))
    assert tparams.keys() == want.keys()
    for name, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=PARAM_ATOL)
    assert int(topt["step"]) == int(jopt["step"]) == 1


def test_step_builders_carry_the_prefix(jx):
    """``make_prefill_step`` / ``make_decode_step`` (bfloat16 weights) with
    a bfloat16 prefix against the reference's builders; decode from slot
    P + L."""
    pshape = dataclasses.replace(jx.shapes["prefill_32k"], seq_len=P + L,
                                 global_batch=B)
    dshape = dataclasses.replace(jx.shapes["decode_32k"], seq_len=MAX_LEN,
                                 global_batch=B)
    jfn, jmodel, _ = jx.steps.make_prefill_step(jx.cfg, pshape, jx.ctx)
    jdec, jdmodel, _ = jx.steps.make_decode_step(jx.cfg, dshape, jx.ctx,
                                                 donate=False)
    params = jx.jax.tree.map(jx.jnp.asarray, _at_fan_in(_np(
        jx.jax.jit(jmodel.init)(jx.jax.random.PRNGKey(2)))))
    assert params["embed"].dtype == jx.jnp.bfloat16
    fn, model = tsteps.make_prefill_step(_port_cfg(), device="cpu")
    dec, same = tsteps.make_decode_step(_port_cfg(), device="cpu",
                                        model=model)
    assert same is model and model.embed.dtype == torch.bfloat16
    model.load_state_dict(lm_params_from_jax(_np(params)))
    prefix, toks = _inputs(8)
    bf = torch.from_numpy(prefix).to(torch.bfloat16)
    jb = {"prefix_embeds": jx.jnp.asarray(prefix).astype(jx.jnp.bfloat16),
          "tokens": jx.jnp.asarray(toks)}
    tb = {"prefix_embeds": bf, "tokens": torch.from_numpy(toks)}
    assert {k: tuple(v.shape) for k, v in tb.items()} == {
        k: s.shape for k, s in tsteps.batch_shapes(
            _port_cfg(), dataclasses.replace(
                SHAPES["prefill_32k"], seq_len=P + L,
                global_batch=B)).items()}
    want = jfn(params, jb)
    got = fn(tb)
    assert not got.requires_grad and _rel(want, got) <= F32_TOL
    jc = jx.jax.jit(jdmodel.prefill)(params, jb,
                                     jdmodel.init_cache(B, MAX_LEN))[1]
    tc = model.prefill(tb, model.init_cache(B, MAX_LEN))[1]
    rng = np.random.RandomState(9)
    for t in range(3):
        tok = rng.randint(0, 512, (B, 1)).astype(np.int32)
        want, jc = jdec(params, jx.jnp.asarray(tok),
                        jx.jnp.int32(P + L + t), jc)
        got, tc = dec(torch.from_numpy(tok), P + L + t, tc)
        assert _rel(want, got) <= F32_TOL, t


# ---- the text-only paths -----------------------------------------------------------

def test_text_only_wave_tokens_equal_reference(jx):
    """``BatchServer`` feeds tokens only, as the reference's: a greedy
    wave of ragged prompts gives the reference's tokens."""
    port = _port_model(jx)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 512, size=(n,)).astype(np.int32)
               for n in (5, 7, 3)]
    jserver = jx.serve_loop.BatchServer(jx.model, jx.params, batch_size=3,
                                        max_len=24)
    want = jserver.serve_wave([Request(prompt=p, max_new_tokens=6)
                               for p in prompts])
    got = BatchServer(port, batch_size=3, max_len=24).serve_wave(
        [Request(prompt=p, max_new_tokens=6) for p in prompts])
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.out_tokens, w.out_tokens)


def _prefixed(batch_np, lib):
    """A training batch of the stream's tokens and a prefix drawn from a
    seed the tokens give (``run_training``'s ``batch_to_inputs``)."""
    rng = np.random.RandomState(int(batch_np.sum()) % 2 ** 31)
    prefix = rng.randn(batch_np.shape[0], P, D).astype(np.float32)
    return _batch(prefix, batch_np, lib)


def test_run_training_with_a_prefix_matches_reference(jx, tmp_path):
    """Four steps of ``run_training`` whose ``batch_to_inputs`` adds a
    prefix, from the same parameters, give the reference's losses.  (The
    reference's loop needs the prefix here: its step's shardings name
    ``prefix_embeds``, and a batch of tokens alone does not match them;
    the port's runs the text alone, ``test_launchers_run_the_vlm_config_
    text_only``.)"""
    data = DataConfig(vocab=512, seq_len=L - 1, global_batch=4, seed=11)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=P + L - 1,
                                global_batch=4)
    jshape = dataclasses.replace(jx.shapes["train_4k"], seq_len=P + L - 1,
                                 global_batch=4)
    kw = dict(total_steps=4, ckpt_every=100, log_every=100)
    _, _, jhist = jx.train_loop.run_training(
        jx.train_loop.TrainLoopConfig(ckpt_dir=str(tmp_path / "j"), **kw),
        jx.program(1, jshape),
        jx.synthetic.DataConfig(**dataclasses.asdict(data)),
        lambda: jx.params, batch_to_inputs=lambda b: _prefixed(b, "jax"),
        log=None)
    prog = tsteps.make_train_step(_port_cfg(), shape,
                                  ocfg=tadamw.AdamWConfig(**OCFG),
                                  microbatches=1, device="cpu")
    _, _, hist = run_training(
        TrainLoopConfig(ckpt_dir=str(tmp_path / "t"), **kw), prog, data,
        lambda: lm_params_from_jax(_np(jx.params)),
        batch_to_inputs=lambda b: _prefixed(b, "torch"), log=None)
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] == \
        [0, 1, 2, 3]
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], rtol=1e-5)


def test_launchers_run_the_vlm_config_text_only(tmp_path, capsys):
    done = serve_launch.main(["--arch", ARCH, "--reduced", "--requests", "2",
                              "--batch", "2", "--prompt-len", "5",
                              "--new-tokens", "3", "--max-len", "16",
                              "--device", "cpu"])
    assert [r.out_tokens.shape for r in done] == [(3,), (3,)]
    res = train_launch.main(["--arch", ARCH, "--reduced", "--steps", "2",
                             "--batch", "2", "--seq", "8", "--device", "cpu",
                             "--ckpt-every", "0",
                             "--ckpt-dir", str(tmp_path)])
    hist = res[-1]
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)


# ---- parameters --------------------------------------------------------------------

def test_converter_names_and_bits(jx):
    model = build_model(_port_cfg(), device="cpu")
    sd = model.state_dict()
    got = lm_params_from_jax(_np(jx.params))
    assert got.keys() == sd.keys()
    for name, t in got.items():
        assert t.shape == sd[name].shape and t.dtype == torch.float32, name
    stacked = np.asarray(jx.params["units"]["layer0"]["mlp"]["w_up"])
    assert torch.equal(got["layers.1.mlp.w_up"],
                       torch.from_numpy(stacked[1].copy()))
    model.load_state_dict(got)
    back = lm_params_to_jax(dict(model.named_parameters()), 1)
    flat = {}

    def walk(t, pre=()):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, pre + (k,))
            else:
                flat[pre + (k,)] = v
    walk(_np(jx.params))
    for path, want in flat.items():
        node = back
        for k in path:
            node = node[k]
        assert np.array_equal(np.asarray(torch.as_tensor(node).detach()),
                              want), path


def test_param_count_matches_reference(jx):
    cfg, jcfg = get_config(ARCH), jx.get_config(ARCH)
    assert tsteps.param_count(cfg) == jx.steps.param_count(jcfg) == \
        19_862_722_560
    assert tsteps.active_param_count(cfg) == \
        jx.steps.active_param_count(jcfg)


# ---- on the card -----------------------------------------------------------------

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


def _card_and_cpu(cuda_device, **kw):
    """The reduced model on the CPU and on the card with the same weights,
    its layer matrices at fan-in scale (the module docstring's reason)."""
    cfg = _port_cfg(**kw)
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if name.startswith("layers.") and p.dim() == 2:
                p.mul_((cfg.n_units / p.shape[0]) ** 0.5)
    cpu.drop_cast()
    card = build_model(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    return card, cpu


@pytest.mark.cuda
def test_cuda_reduced_vlm_serving_matches_cpu(cuda_device, no_tf32):
    """A prefill with the prefix (2 B7 launches, G = 2) and 3 decode steps
    from slot P + L on the card against the CPU, f32, 1e-4."""
    card, cpu = _card_and_cpu(cuda_device)
    prefix, toks = _inputs(2, text=L + 3)
    out = []
    for m in (cpu, card):
        dev = m.device
        b = {"prefix_embeds": torch.from_numpy(prefix).to(dev),
             "tokens": torch.from_numpy(toks[:, :L]).to(dev)}
        flash_attention.launches = 0
        got, cache = m.prefill(b, m.init_cache(B, MAX_LEN))
        steps = [got.cpu()]
        for t in range(L, L + 3):
            got, cache = m.decode_step(torch.from_numpy(
                toks[:, t:t + 1]).to(dev), P + t, cache)
            steps.append(got.cpu())
        if dev.type == "cuda":
            assert flash_attention.launches == 2
        out.append(steps)
    for want, got in zip(*out):
        assert bool(torch.isfinite(got).all())
        assert _rel(want.numpy(), got) <= 1e-4


@pytest.mark.cuda
def test_cuda_reduced_vlm_gradients_match_cpu(cuda_device, no_tf32):
    """loss_fn with the prefix and every gradient with remat on the card
    (B7 forward and recompute, B7b) against the CPU, f32, 1e-4 of each
    leaf's max."""
    card, cpu = _card_and_cpu(cuda_device, remat=True)
    prefix, toks = _inputs(3, text=L + 1)
    flash_attention.launches = flash_attention_backward.launches = 0
    grads = []
    for m in (cpu, card):
        dev = m.device
        loss, _ = m.loss_fn({"prefix_embeds": torch.from_numpy(prefix).to(dev),
                             "tokens": torch.from_numpy(toks).to(dev)})
        loss.backward()
        grads.append({n: p.grad.cpu() for n, p in m.named_parameters()})
    assert flash_attention.launches == 4
    assert flash_attention_backward.launches == 2
    for name, want in grads[0].items():
        got = grads[1][name]
        assert bool(torch.isfinite(got).all()), name
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max()), name
