"""Dry run of the port: every (arch x shape) cell built on the ``meta``
device, and the halo-plan and MD cells run on the card.

The port of ``src/repro/launch/dryrun.py``.  The reference lowers and
compiles each cell's step for a TPU pod from abstract inputs and reads
XLA's memory and cost analyses; PyTorch compiles no program, so here:

* an LM cell (:func:`run_cell`) builds the step's program on the ``meta``
  device (:func:`lower_cell`: ``make_train_step`` / ``make_prefill_step``
  / ``make_decode_step``, nothing allocated) and records the parameter
  counts, the model FLOPs (the reference's ``6 N tokens`` to train, ``2 N
  tokens`` to serve), the bytes of the parameters, gradients, AdamW state,
  batch and cache (``launch.steps.input_specs``), the one-card roofline
  terms (:mod:`repro_torch.launch.roofline`, an H100's peaks) and whether
  that state fits one 80 GB card, else how many cards its bytes need
  (activations not counted).  Cells that need many cards are recorded,
  not failed; there is no XLA memory analysis to record;
* a halo cell (:func:`run_halo_cell`, the paper's Fig. 5 analogue) builds
  ``HaloPlan`` on a virtual domain mesh of ``HALO_DD`` and runs its
  forward exchange on the device: the plan's own accounting
  (``plan_stats``, as the reference records it), and in place of XLA's
  collective bytes the bytes the exchange moved, counted from what each
  neighbour transfer delivered (``core.halo.delivered``; ``moved_bytes``,
  per domain, held equal to the plan's forward bytes), the kernels it launched and one forward's
  device time from CUDA events (``None`` off the card);
* an MD cell (:func:`run_md_cell`) runs a short domain-decomposed
  simulation and records the force backend's pair accounting, the halo
  byte accounting, the overlap model, the final potential energy and
  whether every atom was kept.

Records go to ``build/dryrun/`` (or ``--out``), one JSON file a cell.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--force]
  python -m repro_torch.launch.dryrun --halo [--device cpu]
  python -m repro_torch.launch.dryrun --md --force-backend sparse
  python -m repro_torch.launch.dryrun --summarize
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import traceback
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.device import resolve_device
from repro_torch.launch import roofline
from repro_torch.launch.steps import (
    active_param_count,
    input_specs,
    make_ctx,
    make_decode_step,
    make_prefill_step,
    make_train_step,
    param_count,
)
from repro_torch.obs import default_registry
from repro_torch.obs import span as obs_span

RESULTS = Path(__file__).resolve().parents[3] / "build" / "dryrun"
AXES = ("z", "y", "x")


def _nbytes(spec) -> int:
    """Bytes of a ``TensorSpec`` or a tensor."""
    return math.prod(spec.shape) * torch.empty((), dtype=spec.dtype
                                               ).element_size()


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return _nbytes(tree)


def lower_cell(arch: str, shape_name: str, overrides=None):
    """The cell's step program on the ``meta`` device: ``(model, cfg,
    shape, ctx, extra)`` (``extra``: a training program's microbatches)."""
    cfg = get_config(arch)
    overrides = overrides or {}
    if overrides.get("cfg"):
        cfg = dataclasses.replace(cfg, **overrides["cfg"])
    shape = SHAPES[shape_name]
    ctx = make_ctx(cfg, shape, device="meta", fsdp=overrides.get("fsdp"))
    kw = {k: overrides[k] for k in ("moe_dispatch",) if k in overrides}
    if shape.kind == "train":
        prog = make_train_step(cfg, shape,
                               microbatches=overrides.get("microbatches"),
                               pod_compress=overrides.get("pod_compress"),
                               zero2=overrides.get("zero2", False),
                               device=ctx.device, **kw)
        return prog.model, cfg, shape, ctx, {"microbatches":
                                             prog.microbatches}
    build = make_prefill_step if shape.kind == "prefill" else \
        make_decode_step
    _, model = build(cfg, device=ctx.device, **kw)
    return model, cfg, shape, ctx, {}


def run_cell(arch: str, shape_name: str, overrides=None, tag: str = "",
             verbose: bool = True) -> dict:
    """One LM cell's record (``ok`` False with the error when its program
    cannot be built)."""
    reg = default_registry()
    sp_cell = None
    record = {"arch": arch, "shape": shape_name, "mesh": "single",
              "tag": tag, "ok": False}
    try:
        with obs_span("dryrun/cell", reg, arch=arch,
                      shape=shape_name) as sp_cell:
            cfg = get_config(arch)
            shape = SHAPES[shape_name]
            ok, why = shape_applicable(cfg, shape)
            if not ok:
                record.update({"skipped": why, "ok": True})
                return record
            with obs_span("dryrun/lower", reg) as sp_lower:
                model, cfg, shape, ctx, extra = lower_cell(
                    arch, shape_name, overrides)
            n_tot, n_act = param_count(cfg), active_param_count(cfg)
            tokens = shape.global_batch * (
                1 if shape.kind == "decode" else shape.seq_len)
            factor = 6.0 if shape.kind == "train" else 2.0
            model_flops = factor * n_act * tokens
            specs = input_specs(cfg, shape, ctx)
            param_bytes = sum(p.numel() * p.element_size()
                              for p in model.parameters())
            train = shape.kind == "train"
            grad_bytes = 4 * n_tot if train else 0     # f32 gradients
            opt_bytes = 8 * n_tot + 4 if train else 0  # AdamW m, v, step
            batch_bytes = _tree_bytes(specs["batch"][0])
            cache_bytes = _tree_bytes(specs["cache"][0]) \
                if "cache" in specs else 0
            state_bytes = param_bytes + grad_bytes + opt_bytes + \
                batch_bytes + cache_bytes
            analytic = roofline.analytic_memory_bytes(
                n_params_stored=n_tot, n_params_active=n_act,
                tokens_local=tokens, d_model=cfg.d_model,
                n_layers=cfg.n_layers, kind=shape.kind,
                opt_bytes_per_param=8.0, cache_bytes_local=cache_bytes)
            terms = roofline.roofline_terms(model_flops, analytic)
            record.update({
                "ok": True,
                "lower_s": round(sp_lower.dur, 3),
                "card": roofline.CARD,
                "params": n_tot,
                "active_params": n_act,
                "model_flops": model_flops,
                "bytes": {"params": param_bytes, "grads": grad_bytes,
                          "adamw": opt_bytes, "batch": batch_bytes,
                          "cache": cache_bytes},
                "state_bytes": state_bytes,
                "fits_one_card": state_bytes <= roofline.HBM_BYTES,
                "cards_needed": max(1, math.ceil(state_bytes /
                                                 roofline.HBM_BYTES)),
                "analytic_bytes": analytic,
                "roofline": terms,
                **extra,
            })
            if verbose:
                print(f"  params={n_tot} active={n_act} "
                      f"state={state_bytes / 1e9:.2f} GB "
                      f"cards={record['cards_needed']}")
                print(f"  roofline:        {terms}")
    except Exception as e:  # noqa: BLE001 -- a cell records its failure
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(record["traceback"])
    finally:
        if sp_cell is not None and sp_cell.dur is not None:
            record["wall_s"] = round(sp_cell.dur, 3)
    return record


def cell_path(arch, shape, mesh_name="single", tag="", out=None):
    return Path(out or RESULTS) / f"{arch}__{shape}__{mesh_name}{tag}.json"


# ---- halo-plan cells (paper Fig. 5 analogue) ---------------------------------

HALO_DD = {"1d": (4, 1, 1), "2d": (4, 4, 1), "3d": (4, 4, 4)}
HALO_BACKENDS = ("serialized", "fused", "pallas", "signal")


def halo_cell_name(dd_name: str, backend: str, width: int = 1,
                   pulses: int = 1, pipeline: str = "off",
                   depth: int = 2, wire_dtype=None) -> str:
    name = f"halo__{dd_name}__{backend}"
    if width != 1:
        name += f"__w{width}"
    if pulses != 1:
        name += f"__p{pulses}"
    if pipeline != "off":
        name += f"__{pipeline}"
        if depth != 2:
            name += f"__d{depth}"
    if wire_dtype:
        name += f"__wd{wire_dtype}"
    return name


def _halo_launches() -> dict:
    from repro_torch.kernels import halo_pack
    return {name: getattr(halo_pack, name).launches
            for name in ("pack", "unpack_add", "put_signal", "fused_pulses")}


def _fwd_device_ms(fn, x, n: int = 20) -> Optional[float]:
    """One forward's device time, the mean over ``n`` calls between CUDA
    events after two warm-up calls; None off the card."""
    if x.device.type != "cuda":
        return None
    for _ in range(2):
        fn(x)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn(x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def run_halo_cell(dd_name: str, backend: str, local=(8, 8, 8), feat: int = 4,
                  width: int = 1, pulses: int = 1, pipeline: str = "off",
                  depth: int = 2, wire_dtype=None, verbose: bool = True,
                  device="cuda", seed: int = 0) -> dict:
    """Build one ``HaloPlan`` on the virtual mesh ``HALO_DD[dd_name]`` and
    run its forward exchange on ``device``: the plan's stats (the
    reference's ``plan_stats``; ``pipeline`` / ``depth`` select the overlap
    model recorded there, ``wire_dtype`` the payload format), the bytes
    the exchange moved per domain against the plan's forward bytes, the
    kernels it launched and one forward's device time."""
    from repro_torch.core import halo
    from repro_torch.core.halo_plan import HaloPlan, HaloSpec
    from repro_torch.launch.mesh import make_mesh

    sp_cell = None
    record = {"kind": "halo", "dd": dd_name, "backend": backend,
              "local": list(local), "width": width, "pulses": pulses,
              "pipeline": pipeline, "pipeline_depth": depth,
              "wire_dtype": wire_dtype, "ok": False}
    try:
        with obs_span("dryrun/halo_cell", default_registry(), dd=dd_name,
                      backend=backend) as sp_cell:
            dev = resolve_device(device)
            dd = HALO_DD[dd_name]
            # width 0 on non-decomposed dims: a 1D DD exchanges z-slabs only
            widths = tuple(width if n > 1 else 0 for n in dd)
            pulses_per_dim = tuple(pulses if w else 1 for w in widths)
            spec = HaloSpec(axis_names=AXES, widths=widths, backend=backend,
                            dtype="float32", feature_elems=feat,
                            pulses=pulses_per_dim, wire_dtype=wire_dtype)
            plan = HaloPlan.build(spec, make_mesh(dd, AXES), device=dev)
            gen = torch.Generator().manual_seed(seed)
            x = torch.randn(dd + tuple(local) + (feat,), generator=gen
                            ).to(dev)
            stats = plan.stats(local, pipeline=pipeline, depth=depth)
            before, delivered = _halo_launches(), halo.delivered.bytes
            ext = plan.fwd(x)
            moved = halo.delivered.bytes - delivered
            launches = {k: v - before[k] for k, v in _halo_launches().items()}
            n_dom = math.prod(dd)
            want = tuple(n + w for n, w in zip(local, widths))
            if tuple(ext.shape) != dd + want + (feat,) or \
                    not bool(torch.isfinite(ext).all()):
                raise RuntimeError(f"fwd gave {tuple(ext.shape)}, want "
                                   f"{dd + want + (feat,)}, finite")
            if moved % n_dom:
                raise RuntimeError(f"{moved} bytes moved over "
                                   f"{n_dom} domains")
            record.update({
                "ok": True,
                "devices": n_dom,
                "device": str(dev),
                # latency + overlap models live inside plan_stats
                "plan_stats": stats,
                "moved_bytes": moved // n_dom,
                "moved_bytes_total": moved,
                "plan_fwd_bytes": stats["wire_bytes_fwd"],
                "launches": launches,
                "fwd_device_ms": _fwd_device_ms(plan.fwd, x),
            })
            if record["moved_bytes"] != stats["wire_bytes_fwd"]:
                record["ok"] = False
                record["error"] = (f"moved {record['moved_bytes']} bytes a "
                                   f"domain, the plan says "
                                   f"{stats['wire_bytes_fwd']}")
            if verbose:
                st = stats
                print(f"  plan: total={st['total_bytes']} "
                      f"ser_crit={st['serialized_critical_bytes']} "
                      f"fused_crit={st['fused_critical_bytes']} "
                      f"exposed/step={st['exposed_phases_per_step']}")
                if wire_dtype:
                    print(f"  wire: bytes={st['wire_bytes']} "
                          f"reduction={st['wire_reduction']:.2f}x")
                print(f"  moved {record['moved_bytes']} B a domain, "
                      f"launches {launches}, fwd device ms "
                      f"{record['fwd_device_ms']}")
    except Exception as e:  # noqa: BLE001 -- a cell records its failure
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(record["traceback"])
    finally:
        if sp_cell is not None and sp_cell.dur is not None:
            record["wall_s"] = round(sp_cell.dur, 3)
    return record


def _write(path: Path, rec: dict) -> None:
    path.write_text(json.dumps(rec, indent=1, default=str))


def run_halo_cells(force: bool = False, width: int = 1, pulses: int = 1,
                   pipeline: str = "off", depth: int = 2, wire_dtype=None,
                   device="cuda", out=None, dds=None) -> list:
    """Every decomposition of ``HALO_DD`` (or ``dds``) on every backend;
    returns the records written."""
    out = Path(out or RESULTS)
    out.mkdir(parents=True, exist_ok=True)
    records = []
    for dd_name in dds or HALO_DD:
        for backend in HALO_BACKENDS:
            name = halo_cell_name(dd_name, backend, width, pulses,
                                  pipeline, depth, wire_dtype)
            path = out / f"{name}.json"
            if path.exists() and not force:
                print(f"[skip] {path.name} exists")
                continue
            print(f"[halo] {dd_name} x {backend} w={width} p={pulses} "
                  f"pipeline={pipeline} depth={depth} "
                  f"wire={wire_dtype}", flush=True)
            rec = run_halo_cell(dd_name, backend, width=width,
                                pulses=pulses, pipeline=pipeline,
                                depth=depth, wire_dtype=wire_dtype,
                                device=device)
            _write(path, rec)
            records.append(rec)
            print(f"[done] {path.name}: {'OK' if rec['ok'] else 'FAIL'} "
                  f"({rec['wall_s']}s)", flush=True)
    return records


# ---- MD force-engine cells (pair-schedule backends on a DD mesh) -------------

def _nb_launches() -> dict:
    from repro_torch.kernels import nonbonded
    return {name: getattr(nonbonded, name).launches
            for name in ("pair_forces", "scatter_accum")}


def run_md_cell(force_backend: str = "dense", halo_backend: str = "fused",
                n_atoms: int = 800, steps: int = 6, dd=(2, 2, 2),
                pipeline: str = "off", depth: int = 2,
                overlap_rebin: bool = False, nstprune: int = 0,
                wire_dtype=None, verbose: bool = True,
                device="cuda") -> dict:
    """Run a short DD simulation on ``device`` and record the force
    backend, its prune ratio / evaluated-work accounting, the
    occupancy-adjusted halo byte accounting, the overlap model at the
    engine's pipeline depth, the final PE and whether every atom was
    kept (the reference's record), with the kernels launched."""
    from repro_torch.core.halo_plan import HaloSpec
    from repro_torch.core.md import MDEngine, make_grappa_like
    from repro_torch.launch.mesh import make_mesh

    sp_cell = None
    dd_name = f"{sum(1 for d in dd if d > 1)}d"
    record = {"kind": "mdforce", "dd": dd_name, "backend": halo_backend,
              "force_backend": force_backend, "pipeline": pipeline,
              "pipeline_depth": depth, "overlap_rebin": overlap_rebin,
              "nstprune": nstprune, "wire_dtype": wire_dtype,
              "n_atoms": n_atoms, "ok": False}
    try:
        with obs_span("dryrun/md_cell", default_registry(), dd=dd_name,
                      backend=halo_backend,
                      force_backend=force_backend) as sp_cell:
            dev = resolve_device(device)
            system = make_grappa_like(n_atoms, seed=1)
            spec = HaloSpec(axis_names=AXES, widths=(1, 1, 1),
                            backend=halo_backend)
            eng = MDEngine(system, make_mesh(dd, AXES), spec,
                           pipeline=pipeline, pipeline_depth=depth,
                           overlap_rebin=overlap_rebin,
                           force_backend=force_backend, nstprune=nstprune,
                           wire_dtype=wire_dtype, device=dev)
            before = {**_halo_launches(), **_nb_launches()}
            _, metrics, diags = eng.simulate(steps)
            after = {**_halo_launches(), **_nb_launches()}
            record.update({
                "ok": True,
                "devices": int(np.prod(dd)),
                "device": str(dev),
                "pair_stats": eng.pair_stats(),
                "halo_stats": {k: v for k, v in eng.halo_stats().items()
                               if k in ("total_bytes", "bytes_index",
                                        "useful_bytes", "occupancy",
                                        "wire_bytes", "wire_reduction",
                                        "wire_itemsize_fwd",
                                        "wire_itemsize_rev")},
                "overlap": eng.overlap_stats(),
                "pe_final": float(np.asarray(metrics["pe"])[-1]),
                "n_atoms_conserved": int(diags[-1]["n_atoms"]) == n_atoms,
                "launches": {k: v - before[k] for k, v in after.items()},
            })
            if verbose:
                ps = record["pair_stats"]
                print(f"  force_backend={force_backend} "
                      f"prune_ratio={ps['prune_ratio']:.2f}x "
                      f"evaluated={ps['evaluated_slot_pairs']} "
                      f"(dense {ps['dense_slot_pairs']}) "
                      f"launches {record['launches']}")
    except Exception as e:  # noqa: BLE001 -- a cell records its failure
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(record["traceback"])
    finally:
        if sp_cell is not None and sp_cell.dur is not None:
            record["wall_s"] = round(sp_cell.dur, 3)
    return record


def md_cell_name(halo_backend: str, force_backend: str,
                 pipeline: str = "off", depth: int = 2,
                 overlap_rebin: bool = False, nstprune: int = 0,
                 wire_dtype=None) -> str:
    name = f"mdforce__3d__{halo_backend}__{force_backend}"
    if pipeline != "off":
        name += f"__{pipeline}"
        if depth != 2:
            name += f"__d{depth}"
    if overlap_rebin:
        name += "__or"
    if nstprune:
        name += f"__np{nstprune}"
    if wire_dtype:
        name += f"__wd{wire_dtype}"
    return name


def run_md_cells(force_backend: str, force: bool = False,
                 halo_backend: str = "fused", pipeline: str = "off",
                 depth: int = 2, overlap_rebin: bool = False,
                 nstprune: int = 0, wire_dtype=None, device="cuda",
                 out=None) -> Optional[dict]:
    """One MD cell, written to its file; returns its record (None when
    the file exists and ``force`` is off)."""
    out = Path(out or RESULTS)
    out.mkdir(parents=True, exist_ok=True)
    path = out / (md_cell_name(halo_backend, force_backend, pipeline, depth,
                               overlap_rebin, nstprune, wire_dtype)
                  + ".json")
    if path.exists() and not force:
        print(f"[skip] {path.name} exists")
        return None
    print(f"[mdforce] 3d x {halo_backend} x force={force_backend} "
          f"pipeline={pipeline} depth={depth} "
          f"overlap_rebin={overlap_rebin} nstprune={nstprune} "
          f"wire={wire_dtype}", flush=True)
    rec = run_md_cell(force_backend=force_backend,
                      halo_backend=halo_backend, pipeline=pipeline,
                      depth=depth, overlap_rebin=overlap_rebin,
                      nstprune=nstprune, wire_dtype=wire_dtype,
                      device=device)
    _write(path, rec)
    print(f"[done] {path.name}: {'OK' if rec['ok'] else 'FAIL'} "
          f"({rec['wall_s']}s)", flush=True)
    return rec


def run_cells(archs, shapes, overrides=None, tag: str = "",
              force: bool = False, out=None) -> list:
    """The LM cells of ``archs`` x ``shapes``, each written to its file;
    returns the records written."""
    records = []
    for arch in archs:
        for shape in shapes:
            path = cell_path(arch, shape, "single", tag, out)
            path.parent.mkdir(parents=True, exist_ok=True)
            if path.exists() and not force:
                print(f"[skip] {path.name} exists")
                continue
            print(f"[cell] {arch} x {shape}", flush=True)
            rec = run_cell(arch, shape, overrides, tag)
            _write(path, rec)
            records.append(rec)
            print(f"[done] {path.name}: {'OK' if rec['ok'] else 'FAIL'} "
                  f"({rec['wall_s']}s)", flush=True)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single"],
                    help="one card (the reference's pod meshes need "
                         "several)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--summarize", action="store_true")
    ap.add_argument("--out", default=None,
                    help=f"directory of the records (default {RESULTS})")
    ap.add_argument("--device", default="cuda",
                    help="device of the --halo / --md cells (LM cells are "
                         "built on meta)")
    ap.add_argument("--halo", action="store_true",
                    help="run HaloPlan cells (halo__*)")
    ap.add_argument("--md", action="store_true",
                    help="run MD force-engine cells (mdforce__*)")
    ap.add_argument("--force-backend", default="dense",
                    help="NB force engine for --md cells "
                         "(dense|sparse|pallas)")
    ap.add_argument("--halo-width", type=int, default=1,
                    help="halo width per decomposed dim for --halo cells")
    ap.add_argument("--halo-pulses", type=int, default=1,
                    help="pulses per dim (GROMACS two-pulse case: 2)")
    ap.add_argument("--pipeline", default="off",
                    choices=["off", "double_buffer"],
                    help="step-pipeline overlap model recorded with "
                         "--halo cells")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="in-flight window depth for the overlap model "
                         "(--halo) / the engine ring (--md)")
    ap.add_argument("--overlap-rebin", action="store_true",
                    help="fuse rebin/migration + prune into the --md "
                         "block program (GROMACS DLB analogue)")
    ap.add_argument("--nstprune", type=int, default=0,
                    help="rolling inner-prune cadence for --md cells "
                         "(dual pair list; 0 = outer list only)")
    ap.add_argument("--wire-dtype", default=None,
                    choices=["bfloat16", "float16", "int8_ef", "float32"],
                    help="compressed halo payload format for --halo/--md "
                         "cells (HaloSpec.wire_dtype)")
    ap.add_argument("--moe-dispatch", default=None)
    ap.add_argument("--pod-compress", default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--zero2", action="store_true")
    ap.add_argument("--mamba-dtype", default=None)
    ap.add_argument("--remat-policy", default=None)
    args = ap.parse_args(argv)

    if args.summarize:
        summarize(args.out)
        return None
    if args.halo:
        return run_halo_cells(force=args.force, width=args.halo_width,
                              pulses=args.halo_pulses,
                              pipeline=args.pipeline,
                              depth=args.pipeline_depth,
                              wire_dtype=args.wire_dtype,
                              device=args.device, out=args.out)
    if args.md:
        return run_md_cells(force_backend=args.force_backend,
                            force=args.force, pipeline=args.pipeline,
                            depth=args.pipeline_depth,
                            overlap_rebin=args.overlap_rebin,
                            nstprune=args.nstprune,
                            wire_dtype=args.wire_dtype, device=args.device,
                            out=args.out)

    archs = ARCH_IDS if args.all or not args.arch else \
        [args.arch.replace("-", "_").replace(".", "_")]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    overrides = {}
    if args.moe_dispatch:
        overrides["moe_dispatch"] = args.moe_dispatch
    if args.pod_compress:
        overrides["pod_compress"] = args.pod_compress
    if args.microbatches:
        overrides["microbatches"] = args.microbatches
    if args.zero2:
        overrides["zero2"] = True
    if args.mamba_dtype:
        overrides.setdefault("cfg", {})["mamba_scan_dtype"] = \
            args.mamba_dtype
    if args.remat_policy:
        overrides.setdefault("cfg", {})["remat_policy"] = args.remat_policy
    return run_cells(archs, shapes, overrides or None, args.tag,
                     args.force, args.out)


def summarize(out=None):
    """The reference's table over the LM records of ``out``, with the
    cards the step's state needs in place of the TPU mesh."""
    rows = [json.loads(p.read_text())
            for p in sorted(Path(out or RESULTS).glob("*.json"))]
    rows = [r for r in rows if "arch" in r]
    print("| arch | shape | cards needed | status | GB state | flops | "
          "coll B | compute s | memory s | coll s | dominant | "
          "roofline frac |")
    print("|" + "---|" * 12)
    for r in rows:
        if r.get("skipped"):
            print(f"| {r['arch']} | {r['shape']} | | {r['skipped']} |"
                  + " |" * 8)
            continue
        if not r["ok"]:
            print(f"| {r['arch']} | {r['shape']} | | FAIL "
                  f"{r.get('error', '')[:60]} |" + " |" * 8)
            continue
        t = r["roofline"]
        print(f"| {r['arch']} | {r['shape']} | {r['cards_needed']} | ok "
              f"| {r['state_bytes'] / 1e9:.2f} "
              f"| {r['model_flops']:.2e} "
              f"| 0 "
              f"| {t['compute_s']:.2e} | {t['memory_s']:.2e} "
              f"| {t['collective_s']:.2e} | {t['dominant']} "
              f"| {t['roofline_fraction']:.3f} |")


if __name__ == "__main__":
    main()
