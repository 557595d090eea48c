"""The port's LM serving path against the JAX package.

Same numpy inputs and the same weights (the reference LM's params carried
over by ``convert.lm_params_from_jax``) through the JAX function and its
counterpart in the port, on ``get_config("qwen3-1.7b").reduce()``:

* ``flash_attention``'s plain form against JAX's Pallas kernel in
  interpret mode and the float64 oracle, at the shapes of
  ``tests/test_kernels.py``: 2e-5 in f32 (the reference's own bound);
  bf16 against the oracle to the reference's 0.06, and against JAX's
  kernel to 2**-6 (the two round p and the output to bf16 after float32
  sums taken in other orders: a bf16 ulp of |out| <= 2 is 2**-7);
* ``blocked_attention`` (with ``q_offset`` and ``kv_len_mask``),
  ``decode_attention``, ``rms_norm``, ``layer_norm``, ``rotary`` and
  ``mlp_fwd`` in f32 to 1e-5 (float32 sums in another order);
* ``prefill`` logits (with and without a cache), the filled cache and six
  teacher-forced ``decode_step``s: 1e-5 of max |logit| in f32, 3e-2 with
  ``compute_dtype="bfloat16"`` (activations rounded to 8 bits at the same
  points, after float32 sums in other orders: a few bf16 ulps, 2**-8
  each, through two layers); in f32 also starcoder2-7b's biased
  LayerNorm / GELU stack and mistral-nemo-12b's, both without qk_norm,
  to 1e-4 (the reason stands beside the tolerance);
* ``BatchServer``: greedy tokens equal to JAX's on the same params and
  prompts, and the reference's invariant inside the port (a wave equals
  repeated full prefill).

JAX is imported only inside fixtures (``pytest.importorskip``), so the
``cuda`` cases, which hold the CUDA kernel against its plain form and
skip without a card, run on the card's machine without JAX.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import BatchServer, build_model, get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain,
                                                 kernel_tiling)
from repro_torch.launch import serve as serve_launch
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import LM
from repro_torch.resilience import Watchdog, WaveTimeout
from repro_torch.runtime.serve_loop import (Request, masked_tokens,
                                            throughput_stats)
from _torch_threads import share_cores  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
ARCH = "qwen3-1.7b"
F32_TOL = 1e-5
BF16_LOGIT_TOL = 3e-2


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """Run this module's PyTorch ops on the worker's share of the cores."""
    yield from share_cores()


class Jax:
    """The reference package's LM pieces (imported only where JAX is)."""

    def __init__(self):
        pytest.importorskip("jax")
        import jax
        import jax.numpy as jnp
        from repro.configs import get_config as jax_get_config
        from repro.kernels import ops
        from repro.launch.mesh import make_mesh
        from repro.models import attention, build_model as jax_build_model
        from repro.models import layers
        from repro.parallel.sharding import ShardingCtx
        from repro.runtime import serve_loop
        self.jax, self.jnp, self.ops = jax, jnp, ops
        self.attention, self.layers, self.serve_loop = \
            attention, layers, serve_loop
        self.get_config, self.build_model = jax_get_config, jax_build_model
        self.ctx = ShardingCtx(mesh=make_mesh((1, 1), ("data", "model")),
                               batch_axes=("data",))

    def model(self, compute_dtype="float32", seed=1, arch=ARCH):
        import dataclasses
        cfg = dataclasses.replace(self.get_config(arch).reduce(),
                                  compute_dtype=compute_dtype)
        model = self.build_model(cfg, self.ctx)
        return model, model.init(self.jax.random.PRNGKey(seed))


@pytest.fixture(scope="module")
def jx():
    return Jax()


def _port_model(jax_params, compute_dtype="float32", arch=ARCH):
    import dataclasses
    cfg = dataclasses.replace(get_config(arch).reduce(),
                              compute_dtype=compute_dtype)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(_numpy_tree(jax_params)))
    return model


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def served(jx):
    """(JAX model, JAX params, port model) in f32, same weights."""
    model, params = jx.model()
    return model, params, _port_model(params)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(torch.as_tensor(b).double())
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


# ---- flash_attention: plain form against JAX's kernel ------------------------

FLASH_CASES = [(2, 64, 64, 1, 32, True), (1, 128, 128, 4, 16, True),
               (2, 64, 64, 1, 32, False), (1, 128, 128, 4, 16, False),
               (3, 32, 96, 2, 64, False), (1, 50, 50, 2, 16, True)]


@pytest.mark.parametrize("bh,l,s,g,hd,causal", FLASH_CASES)
def test_plain_flash_matches_jax_kernel_f32(jx, bh, l, s, g, hd, causal):
    rng = np.random.RandomState(l + s)
    q = rng.randn(bh, l, g, hd).astype(np.float32)
    k = rng.randn(bh, s, hd).astype(np.float32)
    v = rng.randn(bh, s, hd).astype(np.float32)
    want = np.asarray(jx.ops.flash_attention(
        *map(jx.jnp.asarray, (q, k, v)), causal=causal, bq=32, bk=32))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          bq=32, bk=32)
    assert got.dtype == torch.float32 and got.shape == (bh, l, g, hd)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    oracle = ref.flash_attention_ref(q, k, v, causal=causal)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=2e-5)


def test_plain_flash_bf16(jx):
    rng = np.random.RandomState(7)
    q = rng.randn(2, 64, 2, 32).astype(np.float32)
    k = rng.randn(2, 64, 32).astype(np.float32)
    v = rng.randn(2, 64, 32).astype(np.float32)
    bf = jx.jnp.bfloat16
    want = np.asarray(jx.ops.flash_attention(
        jx.jnp.asarray(q, bf), jx.jnp.asarray(k, bf), jx.jnp.asarray(v, bf),
        causal=True, bq=32, bk=32), np.float64)
    got = flash_attention(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        causal=True, bq=32, bk=32)
    assert got.dtype == torch.bfloat16
    got = got.double().numpy()
    assert np.abs(got - want).max() <= 2.0 ** -6
    oracle = ref.flash_attention_ref(q, k, v, causal=True).numpy()
    assert np.abs(got - oracle).max() < 0.06


# the bf16 kernel's own blocking (kernel_tiling: bq = 128 // G positions,
# bk = 128 keys) on shapes both forms take unchanged (bq | L, bk | S)
TILED_CASES = ([(2, 256, 256, g, hd, causal) for causal in (True, False)
                for hd in (16, 64) for g in (1, 2)]
               + [(2, 128, 384, 2, 16, False), (2, 128, 256, 1, 64, False)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,l,s,g,hd,causal", TILED_CASES)
def test_plain_flash_at_kernel_tiling_matches_jax_kernel(jx, dtype, bh, l, s,
                                                         g, hd, causal):
    bq, bk = kernel_tiling(g)
    assert l % bq == 0 and s % bk == 0
    rng = np.random.RandomState(l + s + hd + g)
    q = rng.randn(bh, l, g, hd).astype(np.float32)
    k = rng.randn(bh, s, hd).astype(np.float32)
    v = rng.randn(bh, s, hd).astype(np.float32)
    jdt = getattr(jx.jnp, dtype)
    want = np.asarray(jx.ops.flash_attention(
        *(jx.jnp.asarray(x, jdt) for x in (q, k, v)), causal=causal, bq=bq,
        bk=bk), np.float64)
    got = flash_attention_plain(
        *(torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)),
        causal=causal, bq=bq, bk=bk)
    assert got.dtype == getattr(torch, dtype) and got.shape == (bh, l, g, hd)
    tol = 2e-5 if dtype == "float32" else 2.0 ** -6
    assert np.abs(got.double().numpy() - want).max() <= tol


@pytest.mark.parametrize("what", ["dtype", "head_dim", "layout", "shape"])
def test_flash_rejects_what_the_kernel_does_not_take(what):
    q, k, v = torch.randn(1, 8, 2, 16), torch.randn(1, 8, 16), \
        torch.randn(1, 8, 16)
    if what == "dtype":
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            flash_attention(q.double(), k.double(), v.double())
    elif what == "head_dim":
        with pytest.raises(ValueError, match="head_dim 24"):
            flash_attention(torch.randn(1, 8, 2, 24), torch.randn(1, 8, 24),
                            torch.randn(1, 8, 24))
    elif what == "layout":
        with pytest.raises(ValueError, match="contiguous"):
            flash_attention(q, torch.randn(1, 16, 8).transpose(1, 2), v)
    else:
        with pytest.raises(ValueError, match="must"):
            flash_attention(q, k, torch.randn(1, 9, 16))


# ---- attention and layer primitives -----------------------------------------

@pytest.mark.parametrize("causal,q_offset,masked", [
    (True, 0, False), (False, 0, False), (True, 5, False), (True, 0, True),
    (False, 3, True)])
def test_blocked_attention_matches_jax(jx, causal, q_offset, masked):
    rng = np.random.RandomState(3)
    B, L, S, H, HK, hd = 2, 24, 24, 4, 2, 16
    q = rng.randn(B, L, H, hd).astype(np.float32)
    k = rng.randn(B, S, HK, hd).astype(np.float32)
    v = rng.randn(B, S, HK, hd).astype(np.float32)
    mask = rng.rand(B, S) < 0.8 if masked else None
    if masked:
        mask[:, 0] = True            # every row keeps at least one key
    kw = dict(causal=causal, q_offset=q_offset, q_chunk=8, kv_chunk=12)
    want = jx.attention.blocked_attention(
        *map(jx.jnp.asarray, (q, k, v)),
        kv_len_mask=None if mask is None else jx.jnp.asarray(mask), **kw)
    got = tattn.blocked_attention(
        *map(torch.from_numpy, (q, k, v)),
        kv_len_mask=None if mask is None else torch.from_numpy(mask), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_attention_matches_jax(jx, per_row):
    rng = np.random.RandomState(4)
    B, S, H, HK, hd = 3, 20, 4, 2, 16
    q = rng.randn(B, 1, H, hd).astype(np.float32)
    kc = rng.randn(B, S, HK, hd).astype(np.float32)
    vc = rng.randn(B, S, HK, hd).astype(np.float32)
    lens = np.array([5, 11, 20], np.int32) if per_row else 9
    want = jx.attention.decode_attention(
        *map(jx.jnp.asarray, (q, kc, vc)), jx.jnp.asarray(lens))
    got = tattn.decode_attention(
        *map(torch.from_numpy, (q, kc, vc)),
        torch.from_numpy(lens) if per_row else lens)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)


@pytest.mark.parametrize("fn", ["rms_norm", "layer_norm", "rotary",
                                "swiglu", "gelu"])
def test_layer_primitives_match_jax(jx, fn):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 7, 4, 16).astype(np.float32) * 3
    scale = rng.randn(16).astype(np.float32)
    bias = rng.randn(16).astype(np.float32)
    J, T = jx.layers, tlayers
    j, t = jx.jnp.asarray, torch.from_numpy
    if fn == "rms_norm":
        want, got = J.rms_norm(j(x), j(scale), 1e-5), \
            T.rms_norm(t(x), t(scale), 1e-5)
    elif fn == "layer_norm":
        want, got = J.layer_norm(j(x), j(scale), j(bias), 1e-5), \
            T.layer_norm(t(x), t(scale), t(bias), 1e-5)
    elif fn == "rotary":
        pos = rng.randint(0, 4000, size=(2, 7)).astype(np.int32)
        want, got = J.rotary(j(x), j(pos), 1e6), \
            T.rotary(t(x), t(pos), 1e6)
    else:
        mlp = "swiglu" if fn == "swiglu" else "gelu"
        d_ff = 32
        p = {"w_up": rng.randn(16, d_ff).astype(np.float32) / 4,
             "w_down": rng.randn(d_ff, 16).astype(np.float32) / 6}
        if mlp == "swiglu":
            p["w_gate"] = rng.randn(16, d_ff).astype(np.float32) / 4
        else:
            p["b_up"] = rng.randn(d_ff).astype(np.float32)
            p["b_down"] = rng.randn(16).astype(np.float32)
        want = J.mlp_fwd({k: j(v) for k, v in p.items()}, j(x), mlp)
        got = T.mlp_fwd({k: t(v) for k, v in p.items()}, t(x), mlp)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=F32_TOL * max(1.0, np.abs(want).max()))


# ---- the model ---------------------------------------------------------------

# Without qk_norm the reduced configs' attention logits reach ~130
# (weights at 1/sqrt(n_units) = 0.71), against ~3 for qwen3: a float32
# rounding of a logit moves its softmax weight ~40x more, hence 1e-4.
NO_QK_NORM_TOL = 1e-4


@pytest.mark.parametrize("arch,compute_dtype,tol", [
    (ARCH, "float32", F32_TOL), (ARCH, "bfloat16", BF16_LOGIT_TOL),
    ("starcoder2-7b", "float32", NO_QK_NORM_TOL),   # biases, LayerNorm, GELU
    ("mistral-nemo-12b", "float32", NO_QK_NORM_TOL)])
def test_prefill_cache_and_decode_match_jax(jx, arch, compute_dtype, tol):
    model, params = jx.model(compute_dtype, arch=arch)
    port = _port_model(params, compute_dtype, arch)
    rng = np.random.RandomState(6)
    B, L, max_len = 3, 9, 20
    toks = rng.randint(0, model.cfg.vocab, size=(B, L)).astype(np.int32)
    prefill = jx.jax.jit(model.prefill)
    want, _ = prefill(params, {"tokens": jx.jnp.asarray(toks)})
    got, none = port.prefill({"tokens": torch.from_numpy(toks)})
    assert none is None and got.shape == (B, model.cfg.padded_vocab)
    assert _rel(want, got.float()) <= tol

    jc = model.init_cache(B, max_len)
    want, jc = prefill(params, {"tokens": jx.jnp.asarray(toks)}, jc)
    tc = port.init_cache(B, max_len)
    assert tc["layer0"]["attn"]["k"].shape == \
        jc["layer0"]["attn"]["k"].shape
    got, tc = port.prefill({"tokens": torch.from_numpy(toks)}, tc)
    assert _rel(want, got.float()) <= tol
    for name in ("k", "v"):
        assert _rel(np.asarray(jc["layer0"]["attn"][name], np.float32),
                    tc["layer0"]["attn"][name].float()) <= tol

    decode = jx.jax.jit(model.decode_step)
    for t in range(6):
        tok = rng.randint(0, model.cfg.vocab, size=(B, 1)).astype(np.int32)
        want, jc = decode(params, jx.jnp.asarray(tok), jx.jnp.int32(L + t),
                          jc)
        got, tc = port.decode_step(torch.from_numpy(tok), L + t, tc)
        assert _rel(want, got.float()) <= tol, t


def test_greedy_wave_tokens_equal_jax(jx, served):
    model, params, port = served
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, model.cfg.vocab, size=(n,)).astype(np.int32)
               for n in (5, 7, 3)]          # ragged: left padding
    jserver = jx.serve_loop.BatchServer(model, params, batch_size=3,
                                        max_len=32)
    want = jserver.serve_wave([Request(prompt=p, max_new_tokens=6)
                               for p in prompts])
    got = BatchServer(port, batch_size=3, max_len=32).serve_wave(
        [Request(prompt=p, max_new_tokens=6) for p in prompts])
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.out_tokens, w.out_tokens)


def test_wave_serving_matches_stepwise_prefill(served):
    """The reference's own invariant, inside the port."""
    _, _, port = served
    rng = np.random.RandomState(0)
    server = BatchServer(port, batch_size=3, max_len=32)
    reqs = [Request(prompt=rng.randint(0, port.cfg.vocab, size=(5,))
                    .astype(np.int32), max_new_tokens=4) for _ in range(3)]
    out = server.serve_wave(reqs)
    stats = throughput_stats(out)
    assert stats["tokens"] == 12 and stats["tok_per_s"] > 0
    for r in out:
        toks = list(r.prompt)
        for t in range(r.max_new_tokens):
            logits, _ = port.prefill({"tokens": torch.tensor([toks],
                                                             dtype=torch.int32)})
            nxt = int(torch.argmax(logits[0]))
            assert nxt == int(r.out_tokens[t]), (t, toks)
            toks.append(nxt)


def test_wave_timeout_raises_typed_error(served):
    _, _, port = served
    rng = np.random.RandomState(2)
    server = BatchServer(port, batch_size=1, max_len=32, wave_timeout_s=1e-9)
    req = Request(prompt=rng.randint(0, port.cfg.vocab, size=(4,))
                  .astype(np.int32), max_new_tokens=6)
    with pytest.raises(WaveTimeout, match="decode steps"):
        server.serve_wave([req])


def test_generous_timeout_does_not_fire_and_watchdog_observes(served):
    _, _, port = served
    rng = np.random.RandomState(3)
    wd = Watchdog()
    server = BatchServer(port, batch_size=1, max_len=32,
                         wave_timeout_s=600.0, watchdog=wd)
    for _ in range(2):
        req = Request(prompt=rng.randint(0, port.cfg.vocab, size=(4,))
                      .astype(np.int32), max_new_tokens=3)
        out = server.serve_wave([req])
        assert out[0].out_tokens.shape == (3,)
    assert wd.n == 2 and wd.events == 0


def test_watchdog_flags_a_straggler_as_the_reference(jx):
    seen, want_seen = [], []
    ours = Watchdog(on_straggler=lambda *a: seen.append(a))
    theirs = jx.serve_loop.Watchdog(on_straggler=lambda *a:
                                    want_seen.append(a))
    for step, dt in enumerate([1.0, 1.1, 0.9, 1.0, 5.0, 1.0]):
        ours.observe(step, dt)
        theirs.observe(step, dt)
    assert seen == want_seen and ours.events == theirs.events == 1
    assert ours.ewma == theirs.ewma and ours.n == theirs.n


def test_throughput_masks_padding_and_sums_waves():
    def fake(budget, decoded, wave, latency):
        return Request(prompt=np.zeros(1, np.int32), max_new_tokens=budget,
                       out_tokens=np.zeros(decoded, np.int32), wave=wave,
                       latency_s=latency)

    reqs = [fake(5, 5, 0, 1.0), fake(3, 5, 0, 1.0), fake(4, 4, 1, 2.0),
            Request(prompt=np.zeros(1, np.int32), max_new_tokens=9)]
    stats = throughput_stats(reqs)
    assert stats["tokens"] == 5 + 3 + 4
    assert stats["wall_s"] == pytest.approx(3.0)
    assert stats["tok_per_s"] == pytest.approx(12 / 3.0)
    assert masked_tokens([5, 5, 4], [5, 3, 4]) == 12


def test_multi_wave_mixed_budgets_end_to_end(served):
    _, _, port = served
    rng = np.random.RandomState(4)
    server = BatchServer(port, batch_size=2, max_len=32)

    def req(budget):
        return Request(prompt=rng.randint(0, port.cfg.vocab, size=(4,))
                       .astype(np.int32), max_new_tokens=budget)
    done = server.serve_wave([req(6), req(2)])
    done += server.serve_wave([req(3)])
    assert [r.wave for r in done] == [0, 0, 1]
    assert [r.out_tokens.shape[0] for r in done] == [6, 2, 3]
    stats = throughput_stats(done)
    assert stats["tokens"] == 11
    assert stats["wall_s"] == pytest.approx(
        done[0].latency_s + done[2].latency_s)


def test_temperature_sampling_changes_output(served):
    _, _, port = served
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, port.cfg.vocab, size=(6,)).astype(np.int32)
    g = BatchServer(port, batch_size=1, max_len=32).serve_wave(
        [Request(prompt=prompt, max_new_tokens=8)])
    hot = [BatchServer(port, batch_size=1, max_len=32, temperature=2.0,
                       seed=3).serve_wave(
        [Request(prompt=prompt, max_new_tokens=8)])[0].out_tokens
        for _ in range(2)]
    assert not np.array_equal(g[0].out_tokens, hot[0])
    np.testing.assert_array_equal(hot[0], hot[1])    # seeded


def test_wave_past_max_len_raises(served):
    _, _, port = served
    server = BatchServer(port, batch_size=1, max_len=8)
    with pytest.raises(ValueError, match="max_len"):
        server.serve_wave([Request(prompt=np.zeros(5, np.int32),
                                   max_new_tokens=4)])


def test_init_std_follows_reference_rule(jx):
    """Every leaf's init follows ``_init_one``'s rule, stacked unit
    weights at 1/sqrt(n_units), as the reference's own draw does."""
    import dataclasses
    cfg = dataclasses.replace(get_config(ARCH).reduce(), n_layers=4,
                              d_model=128, d_ff=256)
    port = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    jmodel = jx.build_model(dataclasses.replace(
        jx.get_config(ARCH).reduce(), n_layers=4, d_model=128, d_ff=256),
        jx.ctx)
    jparams = _numpy_tree(jmodel.init(jx.jax.random.PRNGKey(0)))
    ours = {k: v.detach() for k, v in port.state_dict().items()}
    theirs = lm_params_from_jax(jparams)
    assert ours.keys() == theirs.keys()
    n_units = cfg.n_units
    for name, t in ours.items():
        if name.endswith(("scale", "q_norm", "k_norm")):
            assert torch.equal(t, torch.ones_like(t)), name
            continue
        want = 0.02 if name in ("embed", "lm_head") else n_units ** -0.5
        got, ref_std = float(t.std()), float(theirs[name].std())
        assert abs(got / want - 1) < 0.1, (name, got, want)
        assert abs(ref_std / want - 1) < 0.1, (name, ref_std, want)


def test_params_round_trip_through_the_converter(served):
    _, params, port = served
    sd = port.state_dict()
    back = lm_params_from_jax(_numpy_tree(params))
    assert sd.keys() == back.keys()
    for name, t in back.items():
        assert torch.equal(sd[name], t), name
    stacked = np.asarray(params["units"]["layer0"]["attn"]["wq"])
    assert torch.equal(sd["layers.1.attn.wq"], torch.from_numpy(stacked[1].copy()))


@pytest.mark.parametrize("arch,item", [("internvl2-26b", "A14: VLM")])
def test_unported_configs_raise_naming_their_item(arch, item):
    """No config is left unported: the last one, a VLM config (``item``),
    builds an ``LM`` whose prefill takes its prefix
    (tests/test_torch_vlm.py holds it against the reference)."""
    cfg = get_config(arch).reduce()
    model = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    assert isinstance(model, LM) and cfg.prefix_tokens, item
    logits, _ = model.prefill({
        "tokens": torch.zeros((1, 3), dtype=torch.int32),
        "prefix_embeds": torch.zeros((1, cfg.prefix_tokens, cfg.d_model))})
    assert logits.shape == (1, cfg.padded_vocab), item


def test_encoder_decoder_config_builds_an_encdec():
    """whisper-small builds the port's EncDec (tests/test_torch_encdec.py
    holds it against the reference)."""
    model = build_model(get_config("whisper-small").reduce(), device="cpu")
    assert isinstance(model, EncDec) and model.cfg.is_encdec


def test_launcher_serves_reduced_on_cpu_and_refuses_md(capsys):
    done = serve_launch.main(["--arch", ARCH, "--reduced", "--requests", "3",
                              "--batch", "2", "--prompt-len", "5",
                              "--new-tokens", "3", "--max-len", "16",
                              "--device", "cpu"])
    assert [r.wave for r in done] == [0, 0, 1]
    assert all(r.out_tokens.shape == (3,) for r in done)
    assert "served 3 requests on cpu" in capsys.readouterr().out
    # --md serves MD replicas now (tests/test_torch_serve.py drives it);
    # what it still refuses is a force backend it does not know
    with pytest.raises(SystemExit):
        serve_launch.main(["--md", "--device", "cpu", "--backend", "nope"])


# ---- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


# the last seven stress the bf16 kernel's tiling (64-row warpgroups,
# 128-row blocks, 128-key tiles): L*G = 135 and 200 (not multiples of 64),
# S = 50 (under one key tile) and 200 (ragged), G = 8, 4 and 1, L = 1
CUDA_FLASH = [(4, 128, 128, 2, 128, True), (3, 100, 100, 2, 64, True),
              (2, 70, 70, 4, 32, False), (2, 33, 90, 1, 16, False),
              (2, 65, 65, 3, 16, True), (2, 45, 45, 3, 64, True),
              (2, 20, 50, 2, 32, False), (1, 200, 200, 1, 128, True),
              (1, 64, 64, 8, 128, True), (2, 96, 96, 4, 16, True),
              (2, 130, 130, 1, 64, True), (3, 1, 77, 2, 128, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,l,s,g,hd,causal", CUDA_FLASH)
def test_cuda_flash_matches_plain(cuda_device, dtype, bh, l, s, g, hd,
                                  causal):
    gen = torch.Generator(device=cuda_device).manual_seed(l * hd + s)
    q = torch.randn(bh, l, g, hd, generator=gen, device=cuda_device)
    k = torch.randn(bh, s, hd, generator=gen, device=cuda_device)
    v = torch.randn(bh, s, hd, generator=gen, device=cuda_device)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert got.dtype == dtype and got.shape == q.shape
    assert float((got.double() - want.double()).abs().max()) <= tol
    oracle = ref.flash_attention_ref(q, k, v, causal=causal)
    assert float((got.double() - oracle).abs().max()) <= \
        (2e-5 if dtype == torch.float32 else 0.06)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_bf16_is_bitwise_repeatable(cuda_device, causal):
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device)
               .to(torch.bfloat16)
               for shape in ((8, 300, 2, 128), (8, 300, 128), (8, 300, 128)))
    first = flash_attention(q, k, v, causal=causal)
    again = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.cuda
def test_cuda_flash_raises_and_counts_nothing_on_bad_input(cuda_device):
    q = torch.randn(1, 8, 2, 16, device=cuda_device)
    k = torch.randn(1, 8, 16, device=cuda_device)
    before = flash_attention.launches
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)
    assert flash_attention.launches == before


@pytest.mark.cuda
def test_cuda_blocked_attention_launches_or_raises(cuda_device):
    q = torch.randn(2, 16, 4, 32, device=cuda_device)
    k = torch.randn(2, 16, 2, 32, device=cuda_device)
    before = flash_attention.launches
    out = tattn.blocked_attention(q, k, k, causal=True)
    want = tattn.blocked_attention(q.cpu(), k.cpu(), k.cpu(), causal=True)
    assert flash_attention.launches == before + 1
    assert float((out.cpu() - want).abs().max()) <= 2e-5
    with pytest.raises(NotImplementedError, match="q_offset"):
        tattn.blocked_attention(q, k, k, causal=True, q_offset=3)
    with pytest.raises(NotImplementedError, match="kv_len_mask"):
        tattn.blocked_attention(q, k, k, causal=False, kv_len_mask=torch.ones(
            2, 16, dtype=torch.bool, device=cuda_device))


@pytest.mark.cuda
def test_cuda_serve_wave_goes_through_the_kernel(cuda_device):
    cfg = get_config(ARCH).reduce()
    model = build_model(cfg).init(
        torch.Generator(device=cuda_device).manual_seed(0))
    before = flash_attention.launches
    reqs = [Request(prompt=np.arange(1, 9, dtype=np.int32) * (i + 1),
                    max_new_tokens=4) for i in range(2)]
    out = BatchServer(model, batch_size=2, max_len=16).serve_wave(reqs)
    assert flash_attention.launches == before + cfg.n_layers   # one prefill
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    want = BatchServer(cpu, batch_size=2, max_len=16).serve_wave(
        [Request(prompt=r.prompt, max_new_tokens=4) for r in reqs])
    for g, w in zip(out, want):
        np.testing.assert_array_equal(g.out_tokens, w.out_tokens)
