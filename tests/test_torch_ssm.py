"""The port's state-space layers (Mamba, RWKV6) against the JAX package.

Same numpy inputs and the same weights (the reference LM's ``PRNGKey(1)``
params carried over by ``convert.lm_params_from_jax``) through the JAX
function and its counterpart in the port, on
``get_config("jamba-v0.1-52b").reduce()`` (Mamba + attention, MoE on
every second layer) and ``get_config("rwkv6-3b").reduce()``, both f32:

* ``ParamDef.scale``: the port's seeded ``conv_w`` draws at 0.5, the other
  leaves as before, and ``stack_defs`` carries the scale;
* ``_causal_conv`` with and without a window, the within-chunk
  ``associative_scan`` against ``lax.associative_scan``, ``_ssm_chunk``,
  and ``mamba_fwd``: prefill with no state, prefill with a state, a
  decode step, the chunk fallbacks (L = 12: one chunk of 12; L = 130:
  two of 65; L = 131, a prime: 131 chunks of 1) and
  ``mamba_scan_dtype="bfloat16"``;
* ``_token_shift``, ``_wkv_scan``, ``rwkv_time_mix`` and
  ``rwkv_channel_mix``, each with and without a state;
* both reduced models: prefill logits, every cache leaf after a prefill,
  teacher-forced decode logits, greedy ``BatchServer`` tokens equal to the
  reference's; the reference's invariant (a prefill then decode steps
  equals a longer prefill) inside the port; the converter round trip;
  ``launch/serve.py`` (their training: ``tests/test_torch_ssm_train.py``).

Tolerances: 1e-5 of max |value| in f32 (the LM slices' bar: float32
sums in another order); copies and shifts bitwise.  The reduced jamba
model is held at 5e-4 of max |value| (logits and every cache leaf): its
Mamba layers at the reference's init (``1 / sqrt(n_units)``, 0.71 here)
drive ``dt`` and the scan's terms large, and f32 alone moves the logits
-- against a float64 run of the port on the same weights and tokens, the
reference's f32 prefill logits are 1.85e-4 of max |logit| away and the
port's 1.20e-4, and the two differ by 9.38e-5; the largest gap over the
test's logits and cache leaves is 2.11e-4 (an ``ssm`` state after three
decode steps).  Each Mamba function alone holds 1e-5.  The bf16 scan is held
at 5e-3 of max |value|: the port rounds after every op where the
reference's program is written (``softplus`` and ``silu`` as XLA expands
them), but XLA's default ``xla_allow_excess_precision`` keeps a fused
chain of bf16 ops in float32 and rounds once; measured 1.64e-3 of max
|out| on this case, and bitwise equal (out and both states) when the
reference runs with ``--xla_allow_excess_precision=false``.

JAX is imported only inside a fixture (``pytest.importorskip``); the
``cuda`` case runs on the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import BatchServer, build_model, get_config
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba as tmamba
from repro_torch.models import rwkv as trwkv
from repro_torch.runtime.serve_loop import Request
from _torch_threads import share_cores  # noqa: E402

JAMBA, RWKV = "jamba-v0.1-52b", "rwkv6-3b"
ARCHES = (JAMBA, RWKV)
F32_TOL = 1e-5
LM_TOL = {JAMBA: 5e-4, RWKV: F32_TOL}        # see the module docstring
BF16_SCAN_TOL = 5e-3
WAVE_LEN = 20


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """Run this module's PyTorch ops on the worker's share of the cores."""
    yield from share_cores()


class Jax:
    """The reference package's SSM and LM pieces, each jitted program built
    once for the module."""

    def __init__(self):
        pytest.importorskip("jax")
        import jax
        import jax.numpy as jnp
        from repro.configs import get_config as jax_get_config
        from repro.launch import steps
        from repro.launch.mesh import make_mesh
        from repro.models import build_model as jax_build_model
        from repro.models import layers, mamba, rwkv
        from repro.parallel.sharding import ShardingCtx
        from repro.runtime import serve_loop
        self.jax, self.jnp, self.steps = jax, jnp, steps
        self.layers, self.mamba, self.rwkv = layers, mamba, rwkv
        self.serve_loop = serve_loop
        self.get_config, self.build_model = jax_get_config, jax_build_model
        self.ctx = ShardingCtx(mesh=make_mesh((1, 1), ("data", "model")),
                               batch_axes=("data",))
        self._models, self._jit = {}, {}

    def cfg(self, arch):
        return self.get_config(arch).reduce()

    def model(self, arch):
        """(model, params) of the reduced config, ``PRNGKey(1)``, once."""
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
        """The reference's ``BatchServer`` (batch 3, max_len 20); its jitted
        prefill and decode serve the model tests too."""
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


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _rel(want, got):
    want = np.asarray(want, np.float64)
    got = np.asarray(torch.as_tensor(got).detach().double())
    assert want.shape == got.shape, (want.shape, got.shape)
    return np.abs(want - got).max() / max(np.abs(want).max(), 1e-30)


def _port_model(jx, arch):
    _, params = jx.model(arch)
    model = build_model(get_config(arch).reduce(), device="cpu")
    model.load_state_dict(lm_params_from_jax(_np(params)))
    return model


def _layer_params(jx, arch, kind, layer=0):
    """The reduced model's unit-0 weights of ``units/layer{layer}/kind``
    as numpy."""
    _, params = jx.model(arch)
    tree = _np(params["units"][f"layer{layer}"][kind])
    return {k: v[0] for k, v in tree.items()}


# ---- ParamDef.scale -----------------------------------------------------------

def test_param_def_scale_draws_conv_w_at_half(jx):
    """``conv_w`` declares scale 0.5: the port's seeded draw has standard
    deviation 0.5 (the reference's too), ``stack_defs`` keeps the scale,
    and the undeclared leaves keep the old rule (``1 / sqrt(n_units)``
    for a stacked ``normal`` leaf, 0.02 for ``small_normal``)."""
    cfg = get_config(JAMBA).reduce()
    stacked = tlayers.stack_defs(tmamba.mamba_defs(cfg), 3)
    assert stacked["conv_w"].scale == 0.5 and stacked["in_proj"].scale is None
    jstacked = jx.layers.stack_defs(jx.mamba.mamba_defs(jx.cfg(JAMBA)), 3)
    for k, d in stacked.items():
        assert (d.shape, d.init, d.scale) == \
            (jstacked[k].shape, jstacked[k].init, jstacked[k].scale), k
    port = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    _, jparams = jx.model(JAMBA)
    sd = port.state_dict()
    n = cfg.n_units
    di, dc = cfg.d_inner_mamba, cfg.mamba_d_conv
    conv = torch.stack([sd[f"layers.{u * 8 + i}.mamba.conv_w"]
                        for u in range(n) for i in range(8) if i != 4])
    # 14 layers x di x dc = 7168 draws: the std's sampling error is ~0.8 %
    assert conv.numel() == 14 * di * dc
    assert abs(float(conv.std()) / 0.5 - 1) < 0.05
    ref = np.stack([np.asarray(jparams["units"][f"layer{i}"]["mamba"]
                               ["conv_w"]) for i in range(8) if i != 4])
    assert abs(float(ref.std()) / 0.5 - 1) < 0.05
    for name, want in (("in_proj", n ** -0.5), ("out_proj", n ** -0.5),
                       ("x_proj", n ** -0.5)):
        t = torch.stack([sd[f"layers.{u * 8}.mamba.{name}"]
                         for u in range(n)])
        assert abs(float(t.std()) / want - 1) < 0.1, name
    assert abs(float(sd["embed"].std()) / 0.02 - 1) < 0.1
    for name in ("A_log", "D"):
        assert torch.equal(sd[f"layers.0.mamba.{name}"],
                           torch.ones_like(sd[f"layers.0.mamba.{name}"]))
    for name in ("dt_bias", "conv_b"):
        assert not sd[f"layers.0.mamba.{name}"].any()


# ---- Mamba --------------------------------------------------------------------

@pytest.mark.parametrize("window", [False, True], ids=["zeros", "window"])
def test_causal_conv_matches_reference(jx, window):
    rng = np.random.RandomState(0)
    B, L, di, dc = 2, 9, 16, 4
    x = rng.randn(B, L, di).astype(np.float32)
    w = rng.randn(di, dc).astype(np.float32)
    b = rng.randn(di).astype(np.float32)
    win = rng.randn(B, dc - 1, di).astype(np.float32) if window else None
    jnp = jx.jnp
    want, jwin = jx.mamba._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if win is None else jnp.asarray(win))
    got, twin = tmamba._causal_conv(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        None if win is None else torch.from_numpy(win))
    assert _rel(want, got) <= F32_TOL
    np.testing.assert_array_equal(twin.numpy(), np.asarray(jwin))


@pytest.mark.parametrize("n", [1, 2, 5, 12, 65, 128])
def test_associative_scan_follows_lax(jx, n):
    rng = np.random.RandomState(n)
    a = rng.uniform(0.2, 1.0, (2, n, 3, 4)).astype(np.float32)
    b = rng.randn(2, n, 3, 4).astype(np.float32)

    def combine(e1, e2):
        return e2[0] * e1[0], e2[0] * e1[1] + e2[1]

    ja, jb = jx.jax.jit(lambda a, b: jx.jax.lax.associative_scan(
        combine, (a, b), axis=1))(a, b)
    ta, tb = tmamba.associative_scan(torch.from_numpy(a),
                                     torch.from_numpy(b), dim=1)
    assert _rel(ja, ta) <= 1e-6 and _rel(jb, tb) <= 1e-6
    # and it is the scan: the sequential recurrence in float64
    h = np.zeros((2, 3, 4))
    for t in range(n):
        h = a[:, t].astype(np.float64) * h + b[:, t]
    assert _rel(h, tb[:, -1]) <= 1e-5


def test_ssm_chunk_matches_reference(jx):
    rng = np.random.RandomState(1)
    B, C, di, ds = 2, 12, 16, 8
    dt = np.log1p(np.exp(rng.randn(B, C, di))).astype(np.float32)
    Bc, Cc = (rng.randn(B, C, ds).astype(np.float32) for _ in range(2))
    xin = rng.randn(B, C, di).astype(np.float32)
    A = -np.exp(rng.randn(di, ds) * 0.3).astype(np.float32)
    h0 = rng.randn(B, di, ds).astype(np.float32)
    jh, jy = jx.jax.jit(jx.mamba._ssm_chunk)(h0, (dt, Bc, Cc, xin), A)
    th, ty = tmamba._ssm_chunk(torch.from_numpy(h0),
                               tuple(map(torch.from_numpy,
                                         (dt, Bc, Cc, xin))),
                               torch.from_numpy(A))
    assert _rel(jh, th) <= F32_TOL and _rel(jy, ty) <= F32_TOL


MAMBA_CASES = {                      # (L, state, scan dtype)
    "prefill": (16, False, "float32"),
    "prefill-state": (16, True, "float32"),
    "decode": (1, True, "float32"),
    "L12": (12, False, "float32"),
    "L130-state": (130, True, "float32"),
    "L131-prime": (131, False, "float32"),
    "bf16-scan": (16, True, "bfloat16"),
}


@pytest.mark.parametrize("case", list(MAMBA_CASES))
def test_mamba_fwd_matches_reference(jx, case):
    L, with_state, scan_dtype = MAMBA_CASES[case]
    jc = dataclasses.replace(jx.cfg(JAMBA), mamba_scan_dtype=scan_dtype)
    tc = dataclasses.replace(get_config(JAMBA).reduce(),
                             mamba_scan_dtype=scan_dtype)
    p = _layer_params(jx, JAMBA, "mamba")
    rng = np.random.RandomState(L)
    B, di, ds, dc = 2, tc.d_inner_mamba, tc.mamba_d_state, tc.mamba_d_conv
    x = rng.randn(B, L, tc.d_model).astype(np.float32)
    state = None
    if with_state:
        state = {"conv": rng.randn(B, dc - 1, di).astype(np.float32),
                 "ssm": rng.randn(B, di, ds).astype(np.float32)}
    fn = jx.jit(("mamba_fwd", jc, L, with_state), lambda: jx.jax.jit(
        lambda p, x, s: jx.mamba.mamba_fwd(p, x, jc, state=s)))
    want, jstate = fn(p, x, state)
    got, tstate = tmamba.mamba_fwd(_torch(p), torch.from_numpy(x), tc,
                                   state=None if state is None
                                   else _torch(state))
    tol = BF16_SCAN_TOL if scan_dtype == "bfloat16" else F32_TOL
    assert got.dtype == torch.float32 and _rel(want, got) <= tol
    assert (tstate is None) == (jstate is None)
    if state is not None:
        assert tstate["ssm"].dtype == torch.float32
        for k in ("conv", "ssm"):
            assert _rel(jstate[k], tstate[k]) <= tol, k


def test_mamba_chunks_follow_the_reference_rule():
    """The chunk is the largest C <= 128 dividing L; the chunked scan is
    one recurrence, whatever C: a prime L (C = 1) equals one chunk."""
    cfg = get_config(JAMBA).reduce()
    gen = torch.Generator().manual_seed(5)
    p = {k: tlayers._init_one(gen, d, torch.float32)
         for k, d in tmamba.mamba_defs(cfg).items()}
    x = torch.randn(2, 131, cfg.d_model, generator=gen)
    one, _ = tmamba.mamba_fwd(p, x, cfg, chunk=131)
    many, _ = tmamba.mamba_fwd(p, x, cfg)               # C = 1
    assert _rel(one.numpy(), many) <= F32_TOL
    assert tmamba.softplus(torch.tensor([30.0, -30.0])).tolist() == \
        pytest.approx([30.0, 9.357623e-14], rel=1e-6)


# ---- RWKV ---------------------------------------------------------------------

@pytest.mark.parametrize("with_last", [False, True], ids=["zeros", "carry"])
def test_token_shift_is_the_reference_bitwise(jx, with_last):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 8).astype(np.float32)
    last = rng.randn(2, 1, 8).astype(np.float32) if with_last else None
    want = jx.rwkv._token_shift(jx.jnp.asarray(x), None if last is None
                                else jx.jnp.asarray(last))
    got = trwkv._token_shift(torch.from_numpy(x), None if last is None
                             else torch.from_numpy(last))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
def test_wkv_scan_matches_reference(jx, with_state):
    rng = np.random.RandomState(3)
    B, L, H, hd = 2, 11, 3, 8
    r, k, v = (rng.randn(B, L, H, hd).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(rng.randn(B, L, H, hd) * 0.5)).astype(np.float32)
    u = rng.randn(H, hd).astype(np.float32)
    S0 = rng.randn(B, H, hd, hd).astype(np.float32) if with_state \
        else np.zeros((B, H, hd, hd), np.float32)
    jo, jS = jx.jax.jit(jx.rwkv._wkv_scan)(r, k, v, w, u, S0)
    # a block shorter than L, so the states carry across blocks too
    to, tS = trwkv._wkv_scan(*map(torch.from_numpy, (r, k, v, w, u, S0)),
                             block=4)
    assert _rel(jo, to) <= F32_TOL and _rel(jS, tS) <= F32_TOL
    full, _ = trwkv._wkv_scan(*map(torch.from_numpy, (r, k, v, w, u, S0)))
    assert _rel(full.numpy(), to) <= F32_TOL


def _rwkv_inputs(jx, L, with_state, key):
    tc = get_config(RWKV).reduce()
    rng = np.random.RandomState(L + 10 * with_state)
    B, d, H, hd = 2, tc.d_model, tc.rwkv_heads, tc.rwkv_head_dim
    x = rng.randn(B, L, d).astype(np.float32)
    state = None
    if with_state:
        state = {key: rng.randn(B, 1, d).astype(np.float32)}
        if key == "shift_tm":
            state["wkv"] = rng.randn(B, H, hd, hd).astype(np.float32)
    return tc, x, state


@pytest.mark.parametrize("L,with_state", [(7, False), (7, True), (1, True)],
                         ids=["prefill", "prefill-state", "decode"])
def test_rwkv_time_mix_matches_reference(jx, L, with_state):
    tc, x, state = _rwkv_inputs(jx, L, with_state, "shift_tm")
    jc = jx.cfg(RWKV)
    p = _layer_params(jx, RWKV, "rwkv")
    fn = jx.jit(("time_mix", L, with_state), lambda: jx.jax.jit(
        lambda p, x, s: jx.rwkv.rwkv_time_mix(p, x, jc, s)))
    want, jstate = fn(p, x, state)
    got, tstate = trwkv.rwkv_time_mix(_torch(p), torch.from_numpy(x), tc,
                                      None if state is None
                                      else _torch(state))
    assert _rel(want, got) <= F32_TOL
    assert (tstate is None) == (jstate is None)
    if state is not None:
        np.testing.assert_array_equal(tstate["shift_tm"].numpy(),
                                      np.asarray(jstate["shift_tm"]))
        assert tstate["wkv"].dtype == torch.float32
        assert _rel(jstate["wkv"], tstate["wkv"]) <= F32_TOL


@pytest.mark.parametrize("L,with_state", [(7, False), (7, True), (1, True)],
                         ids=["prefill", "prefill-state", "decode"])
def test_rwkv_channel_mix_matches_reference(jx, L, with_state):
    _, x, state = _rwkv_inputs(jx, L, with_state, "shift_cm")
    p = _layer_params(jx, RWKV, "cm")
    want, jstate = jx.jax.jit(jx.rwkv.rwkv_channel_mix)(p, x, state)
    got, tstate = trwkv.rwkv_channel_mix(_torch(p), torch.from_numpy(x),
                                         None if state is None
                                         else _torch(state))
    assert _rel(want, got) <= F32_TOL
    assert (tstate is None) == (jstate is None)
    if state is not None:
        np.testing.assert_array_equal(tstate["shift_cm"].numpy(),
                                      np.asarray(jstate["shift_cm"]))


# ---- the models -----------------------------------------------------------------

def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("arch", ARCHES)
def test_prefill_cache_and_decode_match_reference(jx, arch):
    model, params = jx.model(arch)
    port = _port_model(jx, arch)
    tol = LM_TOL[arch]
    rng = np.random.RandomState(4)
    B, L = 3, 7
    toks = rng.randint(0, model.cfg.vocab, size=(B, L)).astype(np.int32)
    prefill = jx.server(arch)._prefill
    want, _ = prefill(params, {"tokens": jx.jnp.asarray(toks)})
    got, none = port.prefill({"tokens": torch.from_numpy(toks)})
    assert none is None and _rel(want, got) <= tol
    jc = model.init_cache(B, WAVE_LEN)
    want, jc = prefill(params, {"tokens": jx.jnp.asarray(toks)}, jc)
    tc = port.init_cache(B, WAVE_LEN)
    got, tc2 = port.prefill({"tokens": torch.from_numpy(toks)}, tc)
    assert tc2 is tc and _rel(want, got) <= tol
    jleaves = dict(_flat(_np(jc)))
    tleaves = dict(_flat(tc))
    assert jleaves.keys() == tleaves.keys()
    kinds = {path[1] for path in tleaves}
    assert kinds == ({"rwkv_tm", "rwkv_cm"} if arch == RWKV
                     else {"mamba", "attn"})
    for path, t in tleaves.items():
        assert tuple(t.shape) == jleaves[path].shape, path
        assert str(t.dtype).split(".")[1] == str(jleaves[path].dtype), path
        assert _rel(jleaves[path], t) <= tol, path
    decode = jx.server(arch)._decode
    for t in range(3):
        tok = rng.randint(0, model.cfg.vocab, size=(B, 1)).astype(np.int32)
        want, jc = decode(params, jx.jnp.asarray(tok), jx.jnp.int32(L + t),
                          jc)
        got, tc2 = port.decode_step(torch.from_numpy(tok), L + t, tc)
        assert tc2 is tc and _rel(want, got) <= tol, t
    for path, t in _flat(tc):
        assert _rel(dict(_flat(_np(jc)))[path], t) <= tol, path


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


@pytest.mark.parametrize("arch", ARCHES)
def test_prefill_then_decode_equals_longer_prefill(jx, arch):
    """The reference's own invariant (``test_decode_consistency_smoke``)
    inside the port: a prefill of L - 3 tokens and three decode steps give
    the logits of prefills of L - 2, L - 1 and L tokens."""
    port = _port_model(jx, arch)
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, port.cfg.vocab, (2, 11)).astype(np.int32))
    _, cache = port.prefill({"tokens": toks[:, :8]}, port.init_cache(2, 16))
    for t in range(8, 11):
        got, cache = port.decode_step(toks[:, t:t + 1], t, cache)
        want, _ = port.prefill({"tokens": toks[:, :t + 1]})
        assert _rel(want.numpy(), got) <= LM_TOL[arch], t


@pytest.mark.parametrize("arch", ARCHES)
def test_params_round_trip_through_the_converter(jx, arch):
    _, params = jx.model(arch)
    port = _port_model(jx, arch)
    sd = dict(port.named_parameters())
    back = lm_params_to_jax(sd, len(port.cfg.pattern_unit))
    want = dict(_flat(_np(params)))
    got = dict(_flat(back))
    assert want.keys() == got.keys()
    for path, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[path])
    again = lm_params_from_jax(_np(back))
    assert again.keys() == sd.keys()
    for name, t in again.items():
        assert torch.equal(t, sd[name].detach()), name
    kind = "rwkv" if arch == RWKV else "mamba"
    assert any(f".{kind}." in n for n in sd)


@pytest.mark.parametrize("arch", ARCHES)
def test_param_counts_match_reference(jx, arch):
    for cfg, jcfg in ((get_config(arch), jx.get_config(arch)),
                      (get_config(arch).reduce(), jx.cfg(arch))):
        assert tsteps.param_count(cfg) == jx.steps.param_count(jcfg)
        assert tsteps.active_param_count(cfg) == \
            jx.steps.active_param_count(jcfg)
    port = _port_model(jx, arch)
    assert sum(p.numel() for p in port.parameters()) == \
        tsteps.param_count(port.cfg)


@pytest.mark.parametrize("arch", ARCHES)
def test_launcher_serves_reduced_on_cpu(arch, capsys):
    done = serve_launch.main(["--arch", arch, "--reduced", "--requests", "3",
                              "--batch", "2", "--prompt-len", "5",
                              "--new-tokens", "3", "--max-len", "16",
                              "--device", "cpu"])
    assert [r.wave for r in done] == [0, 0, 1]
    assert all(r.out_tokens.shape == (3,) for r in done)
    assert "served 3 requests on cpu" in capsys.readouterr().out


# ---- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHES)
def test_cuda_reduced_serving_matches_cpu(cuda_device, arch):
    """The reduced model's prefill and decode steps on the card against
    the same weights on the CPU, f32, TF32 off."""
    cfg = get_config(arch).reduce()
    port = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    card = build_model(cfg, device=cuda_device)
    card.load_state_dict(port.state_dict())
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab, (2, 12)).astype(np.int32))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = []
        for m in (port, card):
            dev = m.device
            got, cache = m.prefill({"tokens": toks[:, :9].to(dev)},
                                   m.init_cache(2, 16))
            steps = [got.cpu()]
            for t in range(9, 12):
                got, cache = m.decode_step(toks[:, t:t + 1].to(dev), t,
                                           cache)
                steps.append(got.cpu())
            out.append(steps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for want, got in zip(*out):
        assert bool(torch.isfinite(got).all())
        assert _rel(want.numpy(), got) <= 1e-4
