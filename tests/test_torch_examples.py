"""The port's examples (``examples/torch/*.py``) on the CPU.

Each has the reference example's name (``examples/*.py``), does its work
through the port's API, imports without running it and exposes ``main``;
``main(device="cuda")`` raises where CUDA is absent.  The modules are
loaded by path under their own names, so they never meet the reference's
examples in ``sys.modules`` (``tests/test_examples.py`` imports those by
their bare names).

* ``quickstart.main(device="cpu", n_atoms=200, steps=2)`` runs, and its
  plan stats (dense and ``wire_dtype="bfloat16"``) equal the reference's
  ``HaloPlan.stats`` on the same (2, 2, 2) mesh, exactly (the reference
  on 8 virtual devices, in a subprocess);
* ``md_halo_demo.main`` returns both backends' seconds a step, with and
  without a wire format;
* ``serve_batch`` and ``train_lm`` (reduced, a few steps) run on the CPU.

The ``cuda`` case holds B7 / B7b in float32 at head_dim 96 (qwen3-100m's,
``train_lm --full-100m``) against their plain forms.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_backward,
    flash_attention_backward_plain, flash_attention_plain)

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples" / "torch"
NAMES = ("md_halo_demo", "quickstart", "serve_batch", "train_lm")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_examples_are_the_reference_s():
    assert sorted(p.stem for p in EXAMPLES.glob("*.py")) == list(NAMES)
    ref = {p.stem for p in (REPO / "examples").glob("*.py")}
    assert set(NAMES) == ref - {"ring_attention_demo"}


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_cleanly_and_refuses_a_missing_card(name):
    mod = _load(name)
    assert callable(getattr(mod, "main", None))
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main(device="cuda")


def _reference_stats():
    code = (
        "import json\n"
        "from repro.core import HaloPlan, HaloSpec\n"
        "from repro.launch.mesh import make_md_mesh\n"
        "mesh = make_md_mesh()\n"
        "out = {'mesh': dict(mesh.shape)}\n"
        "for key, wire in (('dense', None), ('wire', 'bfloat16')):\n"
        "    plan = HaloPlan.build(HaloSpec(axis_names=('z', 'y', 'x'),\n"
        "        widths=(1, 1, 1), dtype='float32', feature_elems=4,\n"
        "        wire_dtype=wire), mesh)\n"
        "    out[key] = plan.stats((8, 8, 8))\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    env["PYTHONPATH"] = f"{REPO / 'src'}:{env.get('PYTHONPATH', '')}"
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_quickstart_runs_and_its_stats_are_the_reference_s():
    pytest.importorskip("jax")
    stats, wire, energy = _load("quickstart").main(device="cpu",
                                                   n_atoms=200, steps=2)
    assert set(energy) == {"serialized", "fused"}
    assert all(np.isfinite(E).all() and E.shape == (2,)
               for E in energy.values())
    want = _reference_stats()
    assert want["mesh"] == {"z": 2, "y": 2, "x": 2}
    assert stats["total_bytes"] > 0
    assert json.loads(json.dumps(stats)) == want["dense"]
    assert json.loads(json.dumps(wire)) == want["wire"]


@pytest.mark.parametrize("wire", [None, "bfloat16"])
def test_md_halo_demo_returns_both_backends(wire):
    results = _load("md_halo_demo").main(n_atoms=200, warmup=1, steps=2,
                                         wire_dtype=wire, n_domains=2,
                                         device="cpu")
    assert set(results) == {"serialized", "fused"}
    assert all(dt > 0 for dt in results.values())


def test_serve_batch_serves_every_request():
    done = _load("serve_batch").main(device="cpu")
    assert len(done) == 8 and {r.wave for r in done} == {0, 1}
    assert all(r.out_tokens.shape == (12,) for r in done)


def test_train_lm_trains_on_the_cpu():
    hist = _load("train_lm").main(total_steps=6, device="cpu")
    assert [h["step"] for h in hist] == list(range(6))
    assert all(np.isfinite(h["loss"]) for h in hist)


# ---- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_float32_attention_at_head_dim_96(cuda_device, causal):
    """qwen3-100m's attention (BH 32 = 8 x 4 kv heads, L = S = 64, G 2, hd
    96), f32: B7 within 2e-5 of its plain form and B7b within 2e-5 of max
    |grad| of its plain backward (phase 13 / 19's f32 bars)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(32, 64, 2, 96, generator=gen, device=cuda_device)
    k, v = (torch.randn(32, 64, 96, generator=gen, device=cuda_device)
            for _ in range(2))
    dout = torch.randn(q.shape, generator=gen, device=cuda_device)
    before = flash_attention.launches, flash_attention_backward.launches
    out = flash_attention(q, k, v, causal=causal)
    want = flash_attention_plain(q.cpu(), k.cpu(), v.cpu(), causal=causal)
    assert float((out.cpu() - want).abs().max()) <= \
        2e-5 * float(want.abs().max())
    q_, k_, v_ = (t.clone().requires_grad_() for t in (q, k, v))
    out_ = flash_attention(q_, k_, v_, causal=causal)
    got = torch.autograd.grad(out_, (q_, k_, v_), dout)
    plain = flash_attention_backward_plain(q.cpu(), k.cpu(), v.cpu(),
                                           dout.cpu(), causal=causal)
    for g, w in zip(got, plain):
        assert float((g.cpu() - w).abs().max()) <= \
            2e-5 * float(w.abs().max())
    assert (flash_attention.launches, flash_attention_backward.launches) \
        == (before[0] + 2, before[1] + 1)
