"""The port's encoder-decoder (whisper) against the JAX package.

Same numpy inputs and the same weights (the reference ``EncDec``'s params
carried over by ``convert.encdec_params_from_jax``) through the JAX
function and its counterpart in the port, on
``get_config("whisper-small").reduce()`` (d 64, 2 encoder + 2 decoder
layers, 16 frames, 4 q heads over 2 kv heads of 16, vocab 512, f32) with
the reference's one-device ``("data", "model")`` mesh.  The weights are
the reference's ``init`` with every stacked layer matrix rescaled to ``1 /
sqrt(fan_in)``, as ``tests/test_torch_ssm_train.py`` draws jamba's: at the
reference's own scale, ``1 / sqrt(n_layers)`` = 0.71 at two layers against
0.125 at fan-in 64, the reduced model is too ill-conditioned for float32
to compare two summation orders (measured against a float64 run of the
port on the same weights, where the CPU attention still sums in float32:
gradients up to 2.5e-4 (port) and 2.2e-4 (reference) of a leaf's max,
``dec_layers.1.attn.wk``; the bf16-weight prefill logits of the builder
test 2.1e-5 and 1.7e-5 of their max; at fan-in scale 1.4e-6 and 4.6e-7):

* ``sinusoid`` at d 64 and 768, positions up to 1,499: its frequencies
  within one float32 ulp of the reference's (XLA's exp and PyTorch's
  differ in the last bit of 1 of 32 and 28 of 384 of them), its values
  within 1e-6 plus what that ulp moves the angle, ``pos * f * 2**-23``;
* ``attention_fwd``: cross attention (``kv_x``) and the self branch with
  ``rope=False``, causal and full, within 1e-5 of max |out|;
* ``encode``, ``build_cross_cache``, ``prefill`` without and with a cache
  and 4 ``decode_step``s (logits and every cache leaf) within 1e-5 of
  their max; the reference smoke test's prefill-against-decode check
  inside the port;
* ``loss_fn``: the loss at rtol 1e-5 and every gradient leaf at rtol 1e-5
  plus 2e-6 of the leaf's max (``tests/test_torch_train.py``'s bar), remat
  off and on; the key biases ``bk``, whose gradient is zero (softmax does
  not see a shift of every key's logit), held to 1e-6 of their layer's
  ``bv`` gradient in both packages instead (their float32 residues measure
  up to 3.7e-8 of it);
* one ``make_train_step`` step at two microbatches (``frames`` split with
  ``tokens``) against the reference's: metrics rtol 1e-5, parameters rtol
  1e-5 plus 1e-2 of lr (that file's AdamW bar); ``bk``, whose AdamW step
  is ``lr * g / (|g| + eps)`` of a float32 residue g (measured 1.4e-2 of
  lr apart), within one step of the reference's, ``2 * lr``;
* ``make_prefill_step`` / ``make_decode_step`` (bfloat16 weights) against
  the reference's builders, for whisper and for qwen3-1.7b;
* the converter's names and bits, the init's scales, ``param_count``;
* the launchers refuse an encoder-decoder config.

JAX is imported only inside a fixture (``pytest.importorskip``), and its
programs are compiled once per module; the ``cuda`` cases run the reduced
model on the card (B7 / B7b) against the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import BatchServer, build_model, get_config
from repro_torch.configs import SHAPES
from repro_torch.convert import encdec_params_from_jax, lm_params_from_jax
from repro_torch.data.synthetic import DataConfig
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_backward)
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as train_launch
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tencdec
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import LM
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime.train_loop import TrainLoopConfig, run_training
from _torch_threads import share_cores  # noqa: E402

ARCH = "whisper-small"
F32_TOL = 1e-5
GRAD_TOL = 2e-6            # of a leaf's max, beside rtol 1e-5
B, T, L = 2, 16, 9         # batch, frames (the reduced encoder_seq), text
MAX_LEN = 16
OCFG = dict(lr=8e-3, warmup_steps=2, total_steps=60)
PARAM_ATOL = 1e-2 * OCFG["lr"]     # tests/test_torch_train.py's bar


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """Run this module's PyTorch ops on the worker's share of the cores."""
    yield from share_cores()


class Jax:
    """The reference package's encoder-decoder pieces, each jitted program
    built once for the module."""

    def __init__(self):
        pytest.importorskip("jax")
        import jax
        import jax.numpy as jnp
        from repro.configs import SHAPES as JSHAPES
        from repro.configs import get_config as jax_get_config
        from repro.launch import steps
        from repro.launch.mesh import make_mesh
        from repro.models import attention, encdec
        from repro.models import build_model as jax_build_model
        from repro.optim import adamw
        from repro.parallel.sharding import ShardingCtx
        self.jax, self.jnp, self.attention, self.encdec = \
            jax, jnp, attention, encdec
        self.steps, self.adamw, self.shapes = steps, adamw, JSHAPES
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


@pytest.fixture(scope="module")
def jx():
    return Jax()


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _at_fan_in(params):
    """The reference's params (numpy) with every stacked layer matrix
    ``(n, fan_in, out)`` rescaled from the reference's ``1 / sqrt(n)`` to
    ``1 / sqrt(fan_in)`` (see the module docstring); in its dtype."""
    def walk(tree, stacked):
        return {k: walk(v, stacked or k in ("enc_units", "dec_units"))
                if isinstance(v, dict) else
                (v.astype(np.float32) * np.float32(
                    (v.shape[0] / v.shape[1]) ** 0.5)).astype(v.dtype)
                if stacked and v.ndim == 3 else v
                for k, v in tree.items()}
    return walk(params, False)


def _torch_tree(p):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in p.items()}


def _port_cfg(**kw):
    return dataclasses.replace(get_config(ARCH).reduce(), **kw)


def _port_model(jx, **kw):
    model = build_model(_port_cfg(**kw), device="cpu")
    model.load_state_dict(encdec_params_from_jax(_np(jx.params)))
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
    """(frames (batch, T, d) f32, tokens (batch, text) int32)."""
    rng = np.random.RandomState(seed)
    frames = rng.randn(batch, T, 64).astype(np.float32)
    tokens = rng.randint(0, 512, (batch, text)).astype(np.int32)
    return frames, tokens


def _batch(frames, tokens, lib):
    if lib == "jax":
        import jax.numpy as jnp
        return {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)}
    return {"frames": torch.from_numpy(frames),
            "tokens": torch.from_numpy(tokens)}


def _data_cfg():
    return DataConfig(vocab=512, seq_len=8, global_batch=4, seed=11)


# ---- pieces ----------------------------------------------------------------------

@pytest.mark.parametrize("d_model", [64, 768])
def test_sinusoid_matches_reference(jx, d_model):
    pos = np.concatenate([np.arange(40), [447, 448, 1023, 1499]]) \
        .astype(np.int32).reshape(2, 22)
    want = jx.jax.jit(lambda p: jx.encdec.sinusoid(p, d_model))(
        jx.jnp.asarray(pos))
    got = tencdec.sinusoid(torch.from_numpy(pos), d_model)
    assert got.dtype == torch.float32 and got.shape == (2, 22, d_model)
    half = d_model // 2
    one = np.ones((1, 1), np.int32)     # at position 1: sin(f), cos(f)
    f_want = np.asarray(jx.jax.jit(lambda p: jx.encdec.sinusoid(
        p, d_model))(jx.jnp.asarray(one)))[0, 0]
    f_got = tencdec.sinusoid(torch.from_numpy(one), d_model)[0, 0].numpy()
    np.testing.assert_allclose(f_got, f_want, rtol=0, atol=1e-6)
    f = np.exp(-np.log(1e4) * np.arange(half) / max(half - 1, 1))
    bound = 1e-6 + pos[..., None] * np.concatenate([f, f]) * 2.0 ** -23
    err = np.abs(got.numpy().astype(np.float64) - np.asarray(want))
    assert np.all(err <= bound), float((err - bound).max())


def _dec_layer(jx, i=0):
    """Decoder layer ``i``'s params (the stacked slice) as numpy."""
    return {k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict)
                else v[i]) for k, v in _np(jx.params["dec_units"]).items()}


@pytest.mark.parametrize("case", ["cross", "self-causal", "self-full"])
def test_attention_fwd_without_rope_matches_reference(jx, case):
    p = _dec_layer(jx)["xattn" if case == "cross" else "attn"]
    rng = np.random.RandomState(3)
    x = rng.randn(B, L, 64).astype(np.float32)
    kv = rng.randn(B, T, 64).astype(np.float32)
    pos = np.broadcast_to(np.arange(L), (B, L)).astype(np.int32)
    cross, causal = case == "cross", case == "self-causal"

    def ref(p, x, kv, pos):
        return jx.attention.attention_fwd(
            p, x, jx.cfg, jx.ctx, positions=pos, causal=causal, rope=False,
            kv_x=kv if cross else None,
            kv_positions=jx.jnp.zeros_like(pos) if cross else None)[0]

    want = jx.jax.jit(ref)(jx.jax.tree.map(jx.jnp.asarray, p),
                           *map(jx.jnp.asarray, (x, kv, pos)))
    tx = torch.from_numpy(x)
    got, none = tattn.attention_fwd(
        _torch_tree(p), tx, _port_cfg(), positions=torch.from_numpy(pos),
        causal=causal, rope=False,
        kv_x=torch.from_numpy(kv) if cross else None,
        kv_positions=torch.zeros(B, L, dtype=torch.int32) if cross else None)
    assert none is None and _rel(want, got) <= F32_TOL


def test_encode_and_cross_cache_match_reference(jx):
    frames, _ = _inputs()
    enc = jx.jit("encode", lambda: jx.jax.jit(jx.model.encode))
    want = enc(jx.params, jx.jnp.asarray(frames))
    port = _port_model(jx)
    with torch.no_grad():
        got = port.encode(torch.from_numpy(frames))
    assert got.shape == (B, T, 64) and _rel(want, got) <= F32_TOL
    xc = jx.jit("cross", lambda: jx.jax.jit(jx.model.build_cross_cache))
    wk, wv = xc(jx.params, want)
    with torch.no_grad():
        gk, gv = port.build_cross_cache(torch.from_numpy(np.asarray(want)))
    assert gk.shape == (2, B, T, 2, 16) and gk.dtype == torch.float32
    assert _rel(wk, gk) <= F32_TOL and _rel(wv, gv) <= F32_TOL


def test_prefill_and_decode_match_reference(jx):
    frames, toks = _inputs(4)
    port = _port_model(jx)
    prefill, decode = jx.prefill(), jx.decode()
    want, _ = prefill(jx.params, _batch(frames, toks, "jax"))
    got, none = port.prefill(_batch(frames, toks, "torch"))
    assert none is None and got.shape == (B, 512)
    assert _rel(want, got) <= F32_TOL
    jc = jx.model.init_cache(B, MAX_LEN)
    want, jc = prefill(jx.params, _batch(frames, toks, "jax"), jc)
    tc = port.init_cache(B, MAX_LEN)
    assert jx.jax.tree.map(np.shape, _np(jc)) == \
        {"attn": {k: tuple(t.shape) for k, t in tc["attn"].items()},
         "xk": tuple(tc["xk"].shape), "xv": tuple(tc["xv"].shape)}
    got, same = port.prefill(_batch(frames, toks, "torch"), tc)
    assert same is tc and _rel(want, got) <= F32_TOL
    rng = np.random.RandomState(5)
    for t in range(4):
        tok = rng.randint(0, 512, (B, 1)).astype(np.int32)
        want, jc = decode(jx.params, jx.jnp.asarray(tok), jx.jnp.int32(L + t),
                          jc)
        got, tc = port.decode_step(torch.from_numpy(tok), L + t, tc)
        assert _rel(want, got) <= F32_TOL, t
    for key in ("xk", "xv"):
        assert _rel(jc[key], tc[key]) <= F32_TOL, key
    for key in ("k", "v"):
        assert _rel(jc["attn"][key], tc["attn"][key]) <= F32_TOL, key


def test_prefill_then_decode_equals_longer_prefill(jx):
    """The reference smoke test's consistency check, inside the port: a
    decode step after a cached prefill of L - 1 tokens gives the logits of
    a no-cache prefill of all L (its bar, 2e-2; f32 here)."""
    frames, toks = _inputs(1)
    port = _port_model(jx)
    full, _ = port.prefill(_batch(frames, toks, "torch"))
    _, cache = port.prefill(_batch(frames, toks[:, :L - 1], "torch"),
                            port.init_cache(B, MAX_LEN))
    step, _ = port.decode_step(torch.from_numpy(toks[:, L - 1:]), L - 1,
                               cache)
    assert bool(torch.isfinite(step).all())
    assert float((full - step).abs().max()) < 2e-2
    assert _rel(full.numpy(), step) <= F32_TOL


# ---- loss, gradients, training ---------------------------------------------------

@pytest.mark.parametrize("remat", [False, True], ids=["remat-off",
                                                      "remat-on"])
def test_loss_and_every_gradient_match_reference(jx, remat):
    model = jx.build_model(dataclasses.replace(jx.cfg, remat=remat), jx.ctx)
    vg = jx.jit(("value_and_grad", remat), lambda: jx.jax.jit(
        jx.jax.value_and_grad(model.loss_fn, has_aux=True)))
    frames, toks = _inputs(6, text=L + 1)
    (loss, metrics), grads = vg(jx.params, _batch(frames, toks, "jax"))
    port = _port_model(jx, remat=remat)
    got, got_m = port.loss_fn(_batch(frames, toks, "torch"))
    assert set(got_m) == set(metrics) == {"ce"}
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    got.backward()
    want = encdec_params_from_jax(_np(grads))
    names = [n for n, _ in port.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, p in port.named_parameters():
        assert p.grad is not None, name
        if name.endswith(".bk"):
            scale = float(want[name[:-2] + "bv"].abs().max())
            assert float(p.grad.abs().max()) <= 1e-6 * scale, name
            assert float(want[name].abs().max()) <= 1e-6 * scale, name
            continue
        _close(p.grad, want[name].numpy(), 1e-5, GRAD_TOL)


def test_train_step_at_two_microbatches_matches_reference(jx):
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=8,
                                global_batch=4)
    jshape = dataclasses.replace(jx.shapes["train_4k"], seq_len=8,
                                 global_batch=4)
    jprog = jx.steps.make_train_step(
        jx.cfg, jshape, jx.steps.make_ctx(jx.cfg, jshape, jx.ctx.mesh,
                                          fsdp=False),
        ocfg=jx.adamw.AdamWConfig(**OCFG), microbatches=2, donate=False)
    prog = tsteps.make_train_step(_port_cfg(), shape,
                                  ocfg=tadamw.AdamWConfig(**OCFG),
                                  microbatches=2, device="cpu")
    assert prog.microbatches == jprog.microbatches == 2
    assert isinstance(prog.model, EncDec)
    prog.model.load_state_dict(encdec_params_from_jax(_np(jx.params)))
    frames, toks = _inputs(7, batch=4, text=9)
    params, jopt, jm = jprog.step_fn(jx.params,
                                     jx.adamw.init_state(jx.params),
                                     _batch(frames, toks, "jax"))
    tparams, topt, tm = prog.step_fn(prog.params,
                                     tadamw.init_state(prog.params),
                                     _batch(frames, toks, "torch"))
    assert set(tm) == set(jm) == {"loss", "ce", "grad_norm", "lr"}
    for name in tm:
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-5)
    want = encdec_params_from_jax(_np(params))
    assert tparams.keys() == want.keys()
    for name, p in tparams.items():
        atol = 2 * OCFG["lr"] if name.endswith(".bk") else PARAM_ATOL
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=atol)
    assert int(topt["step"]) == int(jopt["step"]) == 1


@pytest.mark.parametrize("arch", [ARCH, "qwen3-1.7b"])
def test_prefill_and_decode_step_builders_match_reference(jx, arch):
    jcfg, cfg = jx.get_config(arch).reduce(), get_config(arch).reduce()
    pshape = dataclasses.replace(jx.shapes["prefill_32k"], seq_len=L,
                                 global_batch=B)
    dshape = dataclasses.replace(jx.shapes["decode_32k"], seq_len=MAX_LEN,
                                 global_batch=B)
    jfn, jmodel, _ = jx.steps.make_prefill_step(jcfg, pshape, jx.ctx)
    jdec, jdmodel, _ = jx.steps.make_decode_step(jcfg, dshape, jx.ctx,
                                                 donate=False)
    params = jx.jax.jit(jmodel.init)(jx.jax.random.PRNGKey(2))
    if cfg.is_encdec:
        params = jx.jax.tree.map(jx.jnp.asarray, _at_fan_in(_np(params)))
    assert params["embed"].dtype == jx.jnp.bfloat16
    fn, model = tsteps.make_prefill_step(cfg, device="cpu")
    dec, same = tsteps.make_decode_step(cfg, device="cpu", model=model)
    assert same is model and model.cfg.param_dtype == "bfloat16"
    assert isinstance(model, EncDec if cfg.is_encdec else LM)
    convert = encdec_params_from_jax if cfg.is_encdec else lm_params_from_jax
    model.load_state_dict(convert(_np(params)))
    assert model.embed.dtype == torch.bfloat16
    frames, toks = _inputs(8)
    jb, tb = _batch(frames, toks, "jax"), _batch(frames, toks, "torch")
    if not cfg.is_encdec:
        for b in (jb, tb):
            del b["frames"]
    want = jfn(params, jb)
    got = fn(tb)
    assert not got.requires_grad and _rel(want, got) <= F32_TOL
    jc = jx.jax.jit(jdmodel.prefill)(params, jb,
                                     jdmodel.init_cache(B, MAX_LEN))[1]
    tc = model.prefill(tb, model.init_cache(B, MAX_LEN))[1]
    rng = np.random.RandomState(9)
    for t in range(3):
        tok = rng.randint(0, 512, (B, 1)).astype(np.int32)
        want, jc = jdec(params, jx.jnp.asarray(tok), jx.jnp.int32(L + t), jc)
        got, tc = dec(torch.from_numpy(tok), L + t, tc)
        assert _rel(want, got) <= F32_TOL, (arch, t)


# ---- parameters ------------------------------------------------------------------

def test_converter_names_and_bits(jx):
    sd = build_model(_port_cfg(), device="cpu").state_dict()
    got = encdec_params_from_jax(_np(jx.params))
    assert got.keys() == sd.keys()
    for name, t in got.items():
        assert t.shape == sd[name].shape and t.dtype == torch.float32, name
    stacked = np.asarray(jx.params["dec_units"]["xattn"]["wk"])
    assert torch.equal(got["dec_layers.1.xattn.wk"],
                       torch.from_numpy(stacked[1].copy()))
    assert torch.equal(got["enc_norm.bias"],
                       torch.from_numpy(np.asarray(jx.params["enc_norm"]
                                                   ["bias"]).copy()))
    assert not any(".q_norm" in n for n in got)      # MHA, no qk norm


def test_init_draws_the_reference_scales(jx):
    kw = dict(encoder_layers=4, n_layers=4, d_model=128, d_ff=256)
    port = build_model(_port_cfg(**kw), device="cpu").init(
        torch.Generator().manual_seed(0))
    jm = jx.build_model(dataclasses.replace(jx.cfg, **kw), jx.ctx)
    theirs = encdec_params_from_jax(_np(jm.init(jx.jax.random.PRNGKey(0))))
    ours = {k: v.detach() for k, v in port.state_dict().items()}
    assert ours.keys() == theirs.keys()
    for name, t in ours.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale" or leaf.startswith("b"):
            fill = 1.0 if leaf == "scale" else 0.0
            assert torch.equal(t, torch.full_like(t, fill)), name
            assert torch.equal(theirs[name], t), name
            continue
        want = 0.02 if name in ("embed", "lm_head") else 4 ** -0.5
        for std in (float(t.std()), float(theirs[name].std())):
            assert abs(std / want - 1) < 0.1, (name, std, want)


def test_param_count_matches_reference(jx):
    for cfg, jcfg in ((get_config(ARCH), jx.get_config(ARCH)),
                      (_port_cfg(), jx.cfg)):
        assert tsteps.param_count(cfg) == jx.steps.param_count(jcfg)
        assert tsteps.active_param_count(cfg) == \
            jx.steps.active_param_count(jcfg) == tsteps.param_count(cfg)
    assert tsteps.param_count(get_config(ARCH)) == 278_301_696
    assert sum(p.numel() for p in build_model(_port_cfg(), device="cpu")
               .parameters()) == tsteps.param_count(_port_cfg())
    tree = tsteps.abstract_params(get_config(ARCH))
    assert tree["enc_units"]["attn"]["wq"].shape == (12, 768, 768)
    assert tree["dec_units"]["xattn"]["bk"].shape == (12, 768)
    assert tsteps.abstract_opt(get_config(ARCH))["m"]["lm_head"].shape == \
        (768, 51968)


def test_batch_shapes_match_reference(jx):
    cfg, jcfg = get_config(ARCH), jx.get_config(ARCH)
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        for c, jc in ((cfg, jcfg), (get_config("qwen3-1.7b"),
                                    jx.get_config("qwen3-1.7b"))):
            shape = dataclasses.replace(SHAPES[name], seq_len=448,
                                        global_batch=8)
            jshape = dataclasses.replace(jx.shapes[name], seq_len=448,
                                         global_batch=8)
            got = tsteps.batch_shapes(c, shape)
            want = jx.steps.batch_shapes(jc, jshape)
            assert list(got) == list(want), name
            for k, spec in got.items():
                assert spec.shape == want[k].shape, (name, k)
                assert str(spec.dtype).split(".")[1] == \
                    str(want[k].dtype), (name, k)
    assert tsteps.batch_shapes(cfg, dataclasses.replace(
        SHAPES["train_4k"], seq_len=448, global_batch=8))["frames"] \
        .shape == (8, 1500, 768)


# ---- the launchers and the registry ----------------------------------------------

def test_encdec_config_builds_an_encdec_on_cuda_by_default():
    cfg = _port_cfg()
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            build_model(cfg)
    model = build_model(cfg, device="cpu")
    assert isinstance(model, EncDec)
    with pytest.raises(ValueError, match="expert share"):
        build_model(cfg, device="cpu", expert_share=(0, 2))
    with pytest.raises(ValueError, match="EncDec"):
        LM(cfg, device="cpu")
    with pytest.raises(ValueError, match="bfloat16"):
        tsteps.make_decode_step(cfg, device="cpu", model=model)


def test_launchers_refuse_an_encoder_decoder(tmp_path):
    with pytest.raises(NotImplementedError, match="make_prefill_step"):
        serve_launch.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="make_train_step"):
        train_launch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--steps", "1", "--ckpt-dir", str(tmp_path)])
    model = build_model(_port_cfg(), device="cpu")
    with pytest.raises(NotImplementedError, match="frames"):
        BatchServer(model, batch_size=2, max_len=MAX_LEN)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=8,
                                global_batch=4)
    prog = tsteps.make_train_step(_port_cfg(), shape, device="cpu")
    with pytest.raises(NotImplementedError, match="make_train_step"):
        run_training(TrainLoopConfig(total_steps=1, ckpt_dir=str(tmp_path),
                                     ckpt_every=0),
                     prog, _data_cfg(), lambda: None, log=None)
    assert not list(tmp_path.iterdir())


# ---- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _card_and_cpu(cuda_device, **kw):
    """The reduced model on the CPU and on the card with the same weights,
    its layer matrices at fan-in scale (the module docstring's reason)."""
    cfg = _port_cfg(**kw)
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if name.startswith(("enc_layers.", "dec_layers.")) and \
                    p.dim() == 2:
                n = cfg.encoder_layers if name.startswith("enc") \
                    else cfg.n_layers
                p.mul_((n / p.shape[0]) ** 0.5)
    cpu.drop_cast()
    card = build_model(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    return card, cpu


@pytest.fixture
def no_tf32():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.cuda
def test_cuda_reduced_serving_matches_cpu(cuda_device, no_tf32):
    """Prefill (6 B7 launches: 2 encoder, 2 decoder self, 2 cross) and 3
    decode steps (none) on the card against the CPU, f32, 1e-4."""
    card, cpu = _card_and_cpu(cuda_device)
    frames, toks = _inputs(2, text=12)
    out = []
    for m in (cpu, card):
        dev = m.device
        b = {"frames": torch.from_numpy(frames).to(dev),
             "tokens": torch.from_numpy(toks[:, :9]).to(dev)}
        flash_attention.launches = 0
        got, cache = m.prefill(b, m.init_cache(B, MAX_LEN))
        steps = [got.cpu()]
        for t in range(9, 12):
            got, cache = m.decode_step(torch.from_numpy(
                toks[:, t:t + 1]).to(dev), t, cache)
            steps.append(got.cpu())
        if dev.type == "cuda":
            assert flash_attention.launches == 6
        out.append(steps)
    for want, got in zip(*out):
        assert bool(torch.isfinite(got).all())
        assert _rel(want.numpy(), got) <= 1e-4


@pytest.mark.cuda
def test_cuda_reduced_gradients_match_cpu(cuda_device, no_tf32):
    """loss_fn and every gradient with remat on the card (B7 forward and
    recompute, B7b) against the CPU, f32, 1e-4 of each leaf's max (``bk``,
    whose gradient is zero, of its layer's ``bv``)."""
    card, cpu = _card_and_cpu(cuda_device, remat=True)
    frames, toks = _inputs(3, text=L + 1)
    flash_attention.launches = flash_attention_backward.launches = 0
    grads = []
    for m in (cpu, card):
        dev = m.device
        loss, _ = m.loss_fn({"frames": torch.from_numpy(frames).to(dev),
                             "tokens": torch.from_numpy(toks).to(dev)})
        loss.backward()
        grads.append({n: p.grad.cpu() for n, p in m.named_parameters()})
    assert flash_attention.launches == 12
    assert flash_attention_backward.launches == 6
    for name, want in grads[0].items():
        got = grads[1][name]
        assert bool(torch.isfinite(got).all()), name
        if name.endswith(".bk"):
            scale = float(grads[0][name[:-2] + "bv"].abs().max())
            assert float(got.abs().max()) <= 1e-4 * scale, name
            continue
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max()), name


@pytest.mark.cuda
def test_cuda_reduced_train_step_is_bitwise(cuda_device):
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=8,
                                global_batch=4)
    frames, toks = _inputs(4, batch=4, text=9)

    def run():
        prog = tsteps.make_train_step(_port_cfg(), shape,
                                      ocfg=tadamw.AdamWConfig(**OCFG),
                                      microbatches=2)
        prog.model.init(torch.Generator(device=cuda_device).manual_seed(0))
        params, opt = prog.params, tadamw.init_state(prog.params)
        batch = {"frames": torch.from_numpy(frames).to(cuda_device),
                 "tokens": torch.from_numpy(toks).to(cuda_device)}
        losses = []
        for _ in range(2):
            params, opt, m = prog.step_fn(params, opt, batch)
            losses.append(float(m["loss"]))
        return losses, {k: v.detach().clone() for k, v in params.items()}

    la, pa = run()
    lb, pb = run()
    assert la == lb and all(np.isfinite(la))
    for name, p in pb.items():
        assert torch.equal(p, pa[name]), name
