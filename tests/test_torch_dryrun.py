"""The port's dry run (``repro_torch.launch.dryrun``), its shape
specifications (``launch.steps``' ``make_ctx``, ``batch_specs``,
``input_specs``) and its roofline arithmetic against the JAX package, on
the CPU:

* ``batch_specs`` / ``input_specs``: every arch x shape that applies has
  the reference's ``batch_shapes`` and (decode) ``cache_shapes`` (the
  reference's model on its one-device mesh), shape and dtype, every leaf
  placed on the context's device, nothing allocated (``meta``);
* every LM cell of ``--all``: ``params`` / ``active_params`` equal the
  reference's ``param_count`` / ``active_param_count``, the model FLOPs
  its formula, the skipped cells its ``shape_applicable``'s;
* the roofline arithmetic equals the reference's with an H100's peaks in
  place of the TPU's (989 TFLOP/s, 3.35 TB/s), and no TPU constant is
  left in the port;
* the halo cells: ``plan_stats`` equal the reference's ``HaloPlan.stats``
  (its plan built on one device, as
  ``tests/test_torch_halo.py::test_stats_equal_jax`` builds it), and the
  bytes the forward exchange moved equal the plan's forward bytes, on
  every decomposition and backend and with widths 2 / two pulses, the
  double buffer and a wire format;
* the MD cells against the reference's own ``run_md_cell`` on 8 virtual
  devices (a subprocess, as ``tests/test_torch_md_2x2x2.py`` runs its
  reference): ``pair_stats``, ``halo_stats``, ``overlap`` and
  ``n_atoms_conserved`` equal, ``pe_final`` within rtol 1e-5 (float32
  over 6 steps in other summation orders: measured 2.3e-6 dense, 1.4e-6
  sparse);
* the command line writes its records to ``--out`` (by default
  ``build/dryrun``) and summarizes them, with JAX blocked.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import (ARCH_IDS, SHAPES, get_config,
                                 shape_applicable)
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import steps as tsteps
from repro_torch.models.attention import TensorSpec

REPO = Path(__file__).resolve().parent.parent
AXES = ("z", "y", "x")


class Jax:
    """The reference's steps, configs and halo plan (imported only where
    JAX is)."""

    def __init__(self):
        pytest.importorskip("jax")
        import jax
        from repro.configs import SHAPES as JSHAPES
        from repro.configs import get_config as jax_get_config
        from repro.configs import shape_applicable as jax_applicable
        from repro.core import halo_plan
        from repro.launch import hlo_analysis, steps
        from repro.launch.mesh import make_mesh
        from repro.models import build_model as jax_build_model
        self.jax, self.steps, self.shapes = jax, steps, JSHAPES
        self.halo_plan, self.hlo_analysis = halo_plan, hlo_analysis
        self.get_config, self.build_model = jax_get_config, jax_build_model
        self.make_mesh, self.applicable = make_mesh, jax_applicable
        self.ctx = steps._dummy_ctx()


@pytest.fixture(scope="module")
def jx():
    return Jax()


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).split(".")[-1]
    return np.dtype(dt).name


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


# ---- steps: contexts and shape specifications -------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_input_specs_match_reference(jx, arch):
    cfg, jcfg = get_config(arch), jx.get_config(arch)
    jmodel = jx.build_model(jcfg, jx.ctx)
    for name, shape in SHAPES.items():
        if not shape_applicable(cfg, shape)[0]:
            continue
        ctx = tsteps.make_ctx(cfg, shape, device="meta")
        shapes, specs = tsteps.batch_specs(cfg, shape, ctx)
        want = jx.steps.batch_shapes(jcfg, jx.shapes[name])
        assert shapes.keys() == want.keys(), (arch, name)
        for k, s in shapes.items():
            assert isinstance(s, TensorSpec)
            assert tuple(s.shape) == tuple(want[k].shape), (arch, name, k)
            assert _dtype_name(s.dtype) == _dtype_name(want[k].dtype)
            assert specs[k] == torch.device("meta")
        ins = tsteps.input_specs(cfg, shape, ctx)
        assert ins["batch"] == (shapes, specs)
        if shape.kind != "decode":
            assert "cache" not in ins
            continue
        cache, placed = ins["cache"]
        wcache = dict(_leaves(jmodel.cache_shapes(shape.global_batch,
                                                  shape.seq_len)))
        got = dict(_leaves(cache))
        assert got.keys() == wcache.keys(), (arch, name)
        for path, s in got.items():
            assert tuple(s.shape) == tuple(wcache[path].shape), (arch, path)
            assert _dtype_name(s.dtype) == _dtype_name(wcache[path].dtype)
        assert {p: d for p, d in _leaves(placed)} == \
            {p: torch.device("meta") for p in got}


def test_make_ctx_is_one_card():
    cfg, shape = get_config("qwen3-1.7b"), SHAPES["train_4k"]
    ctx = tsteps.make_ctx(cfg, shape, device="cpu")
    assert (ctx.device, ctx.dp, ctx.batch_axes, ctx.seq_axes,
            ctx.fsdp_axis) == (torch.device("cpu"), 1, (), (), None)
    assert tsteps.make_ctx(cfg, shape, device="meta", fsdp=False).dp == 1
    with pytest.raises(NotImplementedError, match="FSDP"):
        tsteps.make_ctx(cfg, shape, device="meta", fsdp=True)


def test_lower_cell_builds_on_meta():
    before = torch.cuda.memory_allocated() if torch.cuda.is_available() \
        else 0
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        model, cfg, shape, ctx, extra = dryrun.lower_cell("internvl2-26b",
                                                          name)
        assert ctx.device.type == "meta"
        assert all(p.device.type == "meta" for p in model.parameters())
        want = "float32" if name == "train_4k" else "bfloat16"
        assert model.embed.dtype == getattr(torch, want)
        assert ("microbatches" in extra) == (name == "train_4k")
    if torch.cuda.is_available():
        assert torch.cuda.memory_allocated() == before
    rec = dryrun.run_cell("qwen3_1_7b", "train_4k",
                          {"pod_compress": "int8"}, verbose=False)
    assert not rec["ok"] and "NotImplementedError" in rec["error"]


# ---- LM cells ---------------------------------------------------------------------

def test_lm_cells_count_the_reference_params(jx, tmp_path):
    recs = dryrun.main(["--all", "--out", str(tmp_path)])
    assert len(recs) == len(ARCH_IDS) * len(SHAPES)
    assert len(list(tmp_path.glob("*__single.json"))) == len(recs)
    counts = {}
    for rec in recs:
        arch, name = rec["arch"], rec["shape"]
        ok, why = jx.applicable(jx.get_config(arch), jx.shapes[name])
        assert rec["ok"], rec.get("error")
        assert bool(rec.get("skipped")) == (not ok), (arch, name)
        if not ok:
            assert rec["skipped"] == why
            continue
        if arch not in counts:
            jcfg = jx.get_config(arch)
            counts[arch] = (jx.steps.param_count(jcfg),
                            jx.steps.active_param_count(jcfg))
        assert (rec["params"], rec["active_params"]) == counts[arch], arch
        shape = SHAPES[name]
        tokens = shape.global_batch * (1 if shape.kind == "decode"
                                       else shape.seq_len)
        factor = 6.0 if shape.kind == "train" else 2.0
        assert rec["model_flops"] == factor * rec["active_params"] * tokens
        b = rec["bytes"]
        assert rec["state_bytes"] == sum(b.values())
        assert rec["cards_needed"] == max(1, -(-rec["state_bytes"]
                                               // int(roofline.HBM_BYTES)))
        assert rec["fits_one_card"] == (rec["cards_needed"] == 1)
        assert b["params"] == rec["params"] * (4 if shape.kind == "train"
                                               else 2)
    assert len(counts) == len(ARCH_IDS)
    # internvl2-26b's prefill state fits one card; its training does not
    internvl = {r["shape"]: r for r in recs if r["arch"] == "internvl2_26b"}
    assert internvl["prefill_32k"]["fits_one_card"]
    assert internvl["train_4k"]["cards_needed"] > 1


def test_roofline_arithmetic_is_the_reference_s_at_the_card_s_peaks(
        jx, monkeypatch):
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (989e12, 3.35e12)
    monkeypatch.setattr(jx.hlo_analysis, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(jx.hlo_analysis, "HBM_BW", roofline.HBM_BW)
    # the port's FLOPs are the model's and its bytes the analytic bound,
    # so the reference's parsed and model figures are the same numbers
    for flops, nbytes in ((1.25e15, 3.5e11), (2e9, 7e10), (8e12, 8e12)):
        parsed = {"flops": flops, "bytes": nbytes, "collective_bytes": 0.0}
        want = jx.hlo_analysis.roofline_terms(parsed, flops)
        got = roofline.roofline_terms(flops, nbytes)
        assert got == {k: want[k] for k in got}
        assert set(want) - set(got) == {"model_flops_per_device",
                                        "useful_flops_ratio"}
    for args in ((19.86e9, 19.86e9, 4096, 6144, 48, "train"),
                 (6.9e9, 1.3e9, 128, 2048, 16, "decode"),
                 (3.07e9, 3.07e9, 32768, 2560, 32, "prefill")):
        assert roofline.analytic_memory_bytes(*args, cache_bytes_local=5e9) \
            == jx.hlo_analysis.analytic_memory_bytes(*args,
                                                     cache_bytes_local=5e9)


def test_no_tpu_constant_in_the_port():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    for path in files:
        text = path.read_text()
        for const in ("197e12", "819e9", "197e+12", "8.19e11"):
            assert const not in text, (path, const)


# ---- halo cells ---------------------------------------------------------------------

HALO_VARIANTS = {
    "base": {},
    "w2p2": dict(width=2, pulses=2),
    "db3": dict(pipeline="double_buffer", depth=3),
    "bf16": dict(wire_dtype="bfloat16"),
}


@pytest.mark.parametrize("variant", list(HALO_VARIANTS))
@pytest.mark.parametrize("dd_name", list(dryrun.HALO_DD))
def test_halo_cells_match_reference_stats_and_move_the_plan_s_bytes(
        jx, dd_name, variant):
    kw = HALO_VARIANTS[variant]
    dd = dryrun.HALO_DD[dd_name]
    width, pulses = kw.get("width", 1), kw.get("pulses", 1)
    widths = tuple(width if n > 1 else 0 for n in dd)
    for backend in dryrun.HALO_BACKENDS:
        rec = dryrun.run_halo_cell(dd_name, backend, verbose=False,
                                   device="cpu", **kw)
        assert rec["ok"], rec.get("error")
        jplan = jx.halo_plan.HaloPlan.build(
            jx.halo_plan.HaloSpec(
                axis_names=AXES, widths=widths, backend=backend,
                dtype="float32", feature_elems=4,
                pulses=tuple(pulses if w else 1 for w in widths),
                wire_dtype=kw.get("wire_dtype")),
            jx.make_mesh((1, 1, 1), AXES))
        want = jplan.stats((8, 8, 8), pipeline=kw.get("pipeline", "off"),
                           depth=kw.get("depth", 2))
        assert rec["plan_stats"] == want, (dd_name, backend)
        assert rec["moved_bytes"] == want["wire_bytes_fwd"] == \
            rec["plan_fwd_bytes"]
        assert rec["moved_bytes_total"] == rec["moved_bytes"] * \
            int(np.prod(dd))
        assert rec["fwd_device_ms"] is None            # not on a card
        assert rec["launches"] == dict.fromkeys(
            ("pack", "unpack_add", "put_signal", "fused_pulses"), 0)


def test_delivered_counts_each_transfer_and_skips_padding_rows():
    """The rolls count what they deliver in ``core.halo.delivered``; the
    signal backend counts the rows each pulse's map names and not the
    rows ``fused_pulses`` pads its maps with: at width 3 over two pulses
    (widths 2 and 1, the second map padded) the forward exchange still
    moves the plan's bytes."""
    from repro_torch.core import halo
    before = halo.delivered.bytes
    halo.recv_from_next(torch.zeros(2, 3), 0)
    halo.recv_from_prev(torch.zeros(2, 3, dtype=torch.float64), 0)
    assert halo.delivered.bytes - before == 24 + 48
    rec = dryrun.run_halo_cell("3d", "signal", width=3, pulses=2,
                               verbose=False, device="cpu")
    assert rec["ok"], rec.get("error")
    pulse_bytes = rec["plan_stats"]["serialized_pulse_bytes"]
    assert pulse_bytes[0::2] == [2 * b for b in pulse_bytes[1::2]]
    assert rec["moved_bytes"] == rec["plan_fwd_bytes"] > 0


# ---- MD cells -------------------------------------------------------------------------

_JAX_MD_SCRIPT = r"""
import json, sys
import jax
assert len(jax.devices()) == 8, jax.devices()
from repro.launch import dryrun   # sets XLA_FLAGS, read only at a start
out = {fb: dryrun.run_md_cell(force_backend=fb, verbose=False)
       for fb in ("dense", "sparse")}
json.dump(out, open(sys.argv[1], "w"), default=str)
"""


@pytest.fixture(scope="module")
def jax_md_cells(jx, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_md") / "cells.json"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = f"{REPO / 'src'}:{env.get('PYTHONPATH', '')}"
    proc = subprocess.run([sys.executable, "-c", _JAX_MD_SCRIPT, str(out)],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    if proc.returncode != 0:
        raise AssertionError(f"JAX MD cells failed:\n{proc.stderr}")
    return json.loads(out.read_text())


@pytest.mark.parametrize("force_backend", ["dense", "sparse"])
def test_md_cells_match_reference(jax_md_cells, force_backend):
    want = jax_md_cells[force_backend]
    assert want["ok"], want.get("error")
    got = json.loads(json.dumps(dryrun.run_md_cell(
        force_backend=force_backend, verbose=False, device="cpu"),
        default=str))
    assert got["ok"], got.get("error")
    for key in ("kind", "dd", "backend", "force_backend", "pipeline",
                "pipeline_depth", "overlap_rebin", "nstprune",
                "wire_dtype", "n_atoms", "devices", "pair_stats",
                "halo_stats", "overlap", "n_atoms_conserved"):
        assert got[key] == want[key], key
    assert got["n_atoms_conserved"] is True
    np.testing.assert_allclose(got["pe_final"], want["pe_final"], rtol=1e-5)
    assert got["launches"] == dict.fromkeys(
        ("pack", "unpack_add", "put_signal", "fused_pulses", "pair_forces",
         "scatter_accum"), 0)


# ---- the command line ---------------------------------------------------------------

def test_records_go_to_build_dryrun_by_default():
    assert dryrun.RESULTS == REPO / "build" / "dryrun"
    assert dryrun.cell_path("a", "b") == REPO / "build" / "dryrun" / \
        "a__b__single.json"


def test_cli_with_jax_blocked_writes_and_summarizes(tmp_path):
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "from repro_torch.launch import dryrun\n"
        "out = sys.argv[1]\n"
        "recs = dryrun.main(['--halo', '--device', 'cpu', '--out', out,\n"
        "                    '--pipeline', 'double_buffer'])\n"
        "assert len(recs) == 12 and all(r['ok'] for r in recs)\n"
        "rec = dryrun.main(['--md', '--device', 'cpu', '--out', out,\n"
        "                   '--force-backend', 'pallas', '--nstprune', '2'])\n"
        "assert rec['ok'] and rec['pair_stats']['nstprune'] == 2, rec\n"
        "recs = dryrun.main(['--arch', 'internvl2-26b', '--shape',\n"
        "                    'decode_32k', '--out', out])\n"
        "assert recs[0]['ok'] and recs[0]['bytes']['cache'] > 0\n"
        "assert dryrun.main(['--arch', 'internvl2-26b', '--shape',\n"
        "                    'decode_32k', '--out', out]) == []\n"
        "dryrun.main(['--summarize', '--out', out])\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO / 'src'}:{env.get('PYTHONPATH', '')}"
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr
    assert "| internvl2_26b | decode_32k | 11 | ok |" in proc.stdout
    assert "cards needed" in proc.stdout
    names = sorted(p.name for p in tmp_path.glob("*.json"))
    assert "halo__3d__signal__double_buffer.json" in names
    assert "mdforce__3d__fused__pallas__np2.json" in names
    assert "internvl2_26b__decode_32k__single.json" in names
    rec = json.loads((tmp_path / "halo__3d__signal__double_buffer.json")
                     .read_text())
    assert rec["moved_bytes"] == rec["plan_stats"]["total_bytes"]
