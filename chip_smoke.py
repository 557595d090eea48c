#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each asserting (any failure exits non-zero with no result line):

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build the CUDA kernels from ``src/repro_torch/csrc`` with nvcc for
   sm_90a, printing the ptxas register / shared-memory lines;
3. kernels: ``halo_pack.pack`` and ``halo_pack.unpack_add`` against their
   plain PyTorch forms at the exact shapes of the grappa-45k main path
   (f32 payload, int32 index exchange, f32 force return) plus f64 cases,
   bitwise; timed with CUDA events beside the plain form, a one-call
   PyTorch yardstick and the byte bound;
4. a small reference: a 300-atom system on the card against the O(N^2)
   direct-force oracle and against the same run on the CPU;
5. the main path: grappa-45k (45,000 atoms) on a 2x2x2 virtual domain
   mesh, ``HaloSpec(backend="pallas")``, f32, ``simulate(40)`` (two
   nstlist=20 blocks with a rebin / migration between them), with the
   kernels' launch counters zeroed just before and read just after; then
   the same run with ``backend="serialized"``, which must be bitwise equal;
6. a torch.profiler (CUPTI) window over steady steps: device time by
   kernel, the halo kernels' device time per launch, device busy share.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BPS = 3.35e12          # H100 SXM device memory, bytes/s
FP32_FLOPS = 67e12         # H100 SXM float32 outside the tensor cores
FP64_FLOPS = 34e12         # H100 SXM float64 outside the tensor cores
AXES = ("z", "y", "x")


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def cuda_ms(fn, n: int = 200, warmup: int = 20) -> float:
    """Mean device time of ``fn`` over ``n`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


# ---- phase 3: kernels at main-path shapes -----------------------------------

def main_path_cases(eng, cell_f, cell_i):
    """Every pack / unpack-add launch of one engine force pass, on real
    state: (kernel, tag, args), args exactly as the pallas backend passes
    them (per-pulse (n_dom, rows, F) views, shared int32 maps)."""
    from repro_torch.core.md.forces import compute_forces

    plan, nd = eng.plan, 3
    local = eng.layout.cells_per_domain
    fwd_maps, rev_maps = plan.backend._maps(plan, tuple(local))
    n_dom = math.prod(eng.axis_sizes)

    def rows2d(x, shape, d):
        sub = x[(slice(None),) * nd + tuple(slice(0, s) for s in shape)]
        return sub.contiguous().reshape(n_dom, math.prod(shape[:d + 1]), -1)

    cases = []
    ext_f = plan.fwd(cell_f[..., :4].contiguous())
    ext_i = plan.fwd(cell_i, wrap_shift=None)
    shape = list(local)
    for pulse, idx in zip(plan.sched.serialized_order(), fwd_maps):
        d = pulse.dim
        cases.append(("pack", f"fwd-{AXES[d]}-f32",
                      (rows2d(ext_f, shape, d), idx)))
        cases.append(("pack", f"fwd-{AXES[d]}-i32",
                      (rows2d(ext_i, shape, d), idx)))
        shape[d] += pulse.width
    F_ext, _ = compute_forces(ext_f, ext_i, eng.layout,
                              eng.system.params.ff)
    for pulse, (pack_idx, add_idx) in zip(
            reversed(plan.sched.serialized_order()), rev_maps):
        d = pulse.dim
        src = rows2d(F_ext, shape, d)
        cases.append(("pack", f"rev-{AXES[d]}-f32", (src, pack_idx)))
        shape[d] -= pulse.width
        dst = rows2d(F_ext, shape, d)
        rows = src[:, pack_idx.long()].contiguous()
        cases.append(("unpack_add", f"rev-{AXES[d]}-f32",
                      (dst, add_idx, rows)))
    # one f64 case per kernel, at the x pulse's shapes
    for kernel, tag, args in list(cases):
        if tag in ("fwd-x-f32", "rev-x-f32"):
            cases.append((kernel, tag.replace("f32", "f64"),
                          tuple(a.double() if a.is_floating_point() else a
                                for a in args)))
    return cases


def case_bytes_ops(kernel, args):
    if kernel == "pack":
        src, idx = args
        n_dom, _, F = src.shape
        moved = 2 * n_dom * idx.shape[0] * F * src.element_size()
        return moved + idx.numel() * 4, 0
    dst, idx, rows = args
    return (2 * dst.numel() * dst.element_size()
            + rows.numel() * rows.element_size() + idx.numel() * 4,
            rows.numel())


def kernel_phase(eng, cell_f, cell_i):
    import torch
    from repro_torch.kernels import halo_pack

    plain = {"pack": halo_pack.pack_plain,
             "unpack_add": halo_pack.unpack_add_plain}
    kern = {"pack": halo_pack.pack, "unpack_add": halo_pack.unpack_add}

    def library(kernel, args):
        if kernel == "pack":           # main-path maps hold no padding
            src, idx = args
            li = idx.long()
            return lambda: torch.index_select(src, 1, li)
        dst, idx, rows = args
        li = idx.long()
        return lambda: dst.index_add(1, li, rows)

    per_kernel = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                      "library_ms": 0.0, "bound_ms": 0.0, "bytes": 0,
                      "ops": 0} for k in kern}
    print("kernel phase: per launch at grappa-45k main-path shapes "
          "(ms; bound = bytes / 3.35 TB/s)")
    for kernel, tag, args in main_path_cases(eng, cell_f, cell_i):
        got = kern[kernel](*args)
        want = plain[kernel](*args)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"{kernel} {tag}: kernel differs from its plain form")
        err = float((got.double() - want.double()).abs().max())
        lib = library(kernel, args)()
        if not tag.endswith("i32"):
            check(torch.equal(lib, want), f"{kernel} {tag}: yardstick "
                  "call computes another function")
        nbytes, ops = case_bytes_ops(kernel, args)
        flops = FP64_FLOPS if tag.endswith("f64") else FP32_FLOPS
        bound = max(nbytes / HBM_BPS, ops / flops) * 1e3
        t_k = cuda_ms(lambda: kern[kernel](*args))
        t_p = cuda_ms(lambda: plain[kernel](*args))
        t_l = cuda_ms(library(kernel, args))
        shapes = " ".join("x".join(map(str, a.shape)) for a in args)
        print(f"  {kernel:10s} {tag:11s} [{shapes}] kernel {t_k:.6f} "
              f"plain {t_p:.6f} library {t_l:.6f} bound {bound:.6f} "
              f"bytes {nbytes} err {err}")
        acc = per_kernel[kernel]
        acc["max_abs_err"] = max(acc["max_abs_err"], err)
        if tag.endswith("f32"):
            # one step's worth: fwd f32 + rev f32 launches (the int32
            # index exchange runs once per block and once per rebin)
            acc["ms"] += t_k
            acc["plain_ms"] += t_p
            acc["library_ms"] += t_l
            acc["bound_ms"] += bound
            acc["bytes"] += nbytes
            acc["ops"] += ops
    return per_kernel


# ---- phase 4: small reference -----------------------------------------------

def reference_phase():
    import numpy as np
    import torch
    from repro_torch import HaloSpec, MDEngine, make_grappa_like, make_mesh
    from repro_torch.core.md import direct_forces_reference

    mesh = make_mesh((1, 1, 1), AXES)
    spec = HaloSpec(AXES, (1, 1, 1), backend="pallas")
    s32 = make_grappa_like(300, seed=11)
    eng = MDEngine(s32, mesh, spec)
    cf, ci, force, diag = eng.rebin_fn(*eng.init_state())
    f_card, = eng.gather_by_id([force], ci)
    f_ref, _ = direct_forces_reference(s32.pos, s32.charge, s32.typ,
                                       s32.box, s32.params.ff)
    err = float(np.abs(f_card - f_ref).max() / np.abs(f_ref).max())
    check(err < 5e-5, f"card forces vs direct oracle: {err}")

    s64 = make_grappa_like(300, seed=11, dtype=np.float64)
    runs = {}
    for dev in ("cuda", "cpu"):
        e = MDEngine(s64, mesh, spec, device=dev)
        (cf, ci), m, d = e.simulate(24)
        runs[dev] = (m, d, e.gather_by_id([cf[..., :3]], ci)[0])
    (mc, dc, pc), (mh, dh, ph) = runs["cuda"], runs["cpu"]
    rel = max(float(np.abs(mc[k] - mh[k]).max() / np.abs(mh[k]).max())
              for k in ("pe", "ke"))
    dpos = float(np.abs(pc - ph).max() / s64.box[0])
    check(rel < 1e-9 and dpos < 1e-9 and dc == dh,
          f"card vs CPU f64 24-step run: rel {rel}, dpos {dpos}")
    print(f"reference phase: card forces vs direct oracle {err:.3e} of the "
          f"force scale; f64 24 steps card vs CPU: PE/KE rel {rel:.3e}, "
          f"positions {dpos:.3e} of the box")


# ---- phase 5: the main path ---------------------------------------------------

def engine_run(system, backend):
    import torch
    from repro_torch import HaloSpec, MDEngine, make_md_mesh
    from repro_torch.kernels import halo_pack

    eng = MDEngine(system, make_md_mesh(8),
                   HaloSpec(AXES, (1, 1, 1), backend=backend))
    state = eng.init_state()
    torch.cuda.synchronize()
    halo_pack.pack.launches = 0
    halo_pack.unpack_add.launches = 0
    t0 = time.perf_counter()
    (cf, ci), m, diags = eng.simulate(40, state=state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"pack": halo_pack.pack.launches,
                "unpack_add": halo_pack.unpack_add.launches}
    # steady state: one more 20-step block on the final state, no rebin
    rs = eng.begin_run((cf, ci))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng.run_block(rs, 20)
    torch.cuda.synchronize()
    block_ms = (time.perf_counter() - t1) * 1e3 / 20
    return eng, (cf, ci), m, diags, wall, launches, block_ms


def main_path_phase():
    import numpy as np
    import torch
    from repro_torch import make_grappa_like

    system = make_grappa_like(45_000, seed=0)
    n = system.n_atoms
    eng, (cf, ci), m, diags, wall, launches, block_ms = engine_run(
        system, "pallas")
    check(eng.layout.cells_per_domain == (7, 7, 7)
          and eng.layout.capacity == 40, f"layout {eng.layout}")
    check(cf.shape == (2, 2, 2, 7, 7, 7, 40, 7), f"cell_f {cf.shape}")
    check(m["pe"].shape == (40,) and m["ke"].shape == (40,),
          "per-step metrics")
    check(len(diags) == 2, f"expected one rebin between blocks: {diags}")
    for d in diags:
        check(d["migration_dropped"] == 0 and d["migration_lost"] == 0
              and d["bin_overflow"] == 0, f"migration counters {d}")
        check(d["n_atoms"] == n, f"atoms lost: {d}")
    E = m["pe"] + m["ke"]
    check(bool(np.all(np.isfinite(E))), "non-finite energy")
    drift = float((E.max() - E.min()) / n)
    check(drift < 5e-3, f"energy drift per atom {drift}")
    check(launches["pack"] > 0 and launches["unpack_add"] > 0,
          f"kernels not launched on the main path: {launches}")
    ms_step = wall * 1e3 / 40
    print(f"main path (pallas): {n} atoms, 2x2x2 domains, 40 steps in "
          f"{wall:.4f} s incl. 2 rebins: {ms_step:.4f} ms/step, "
          f"{n * 40 / wall:.6g} atom-steps/s; steady 20-step block "
          f"{block_ms:.4f} ms/step ({n / block_ms * 1e3:.6g} atom-steps/s); "
          f"energy drift/atom {drift:.3e}; launches {launches}")

    _e, (cf2, ci2), m2, diags2, wall2, _l, block2 = engine_run(
        system, "serialized")
    for k in ("pe", "ke", "mom"):
        check(np.array_equal(m[k], m2[k]),
              f"pallas and serialized runs differ in {k}")
    check(torch.equal(cf, cf2) and torch.equal(ci, ci2) and diags == diags2,
          "pallas and serialized final states differ")
    print(f"main path (serialized): {wall2 * 1e3 / 40:.4f} ms/step incl. "
          f"rebins, steady block {block2:.4f} ms/step; per-step PE/KE and "
          "final state bitwise equal to the pallas run")
    return launches


def _profile(fn, n: int, steps_per_call: int = 1):
    """torch.profiler (CUPTI) over ``n`` calls of ``fn``, each advancing
    ``steps_per_call`` steps: host wall us per step, device kernel us per
    step, kernels per step, the device busy share of the host wall, and
    device us per kernel name per step.  Returns None if the profiler
    records no device kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()                                      # warm the allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name = {}
    for e in kern:
        t, k = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), k + 1)
    device = sum(t for t, _ in by_name.values())
    per = n * steps_per_call
    return (wall_us / per, device / per, len(kern) / per, busy / wall_us,
            {name: (t / per, k / per) for name, (t, k) in by_name.items()})


def profile_phase(n_steps: int = 5):
    """Where a steady grappa-45k step spends device time, by layer and by
    kernel.  The step figure is one whole nstlist block divided by its
    steps, so the block context (the int32 index exchange, once per block) is
    spread as it is on the main path.  Measurement only: prints "not
    measured" if the profiler records no device kernels."""
    from repro_torch import HaloSpec, MDEngine, make_grappa_like, make_md_mesh
    from repro_torch.core.md.forces import compute_forces

    eng = MDEngine(make_grappa_like(45_000, seed=0), make_md_mesh(8),
                   HaloSpec(AXES, (1, 1, 1), backend="pallas"))
    rs = eng.begin_run()
    nst = eng.system.params.nstlist
    step = _profile(lambda: eng.run_block(rs, nst), 1, nst)
    if step is None:
        print("profile: device time not measured (no CUDA events)")
        return
    wall, device, n_kern, busy, by_name = step
    print(f"profile (torch.profiler, one steady {nst}-step pallas "
          f"block, per step): host "
          f"wall {wall / 1e3:.4f} ms/step under the profiler, device kernel "
          f"time {device / 1e3:.4f} ms/step, {n_kern:.2f} kernels/step, "
          f"device busy {busy:.4f} of the host wall")
    payload = rs.cell_f[..., :4]
    ext_f = eng.plan.fwd(payload)
    ext_i = eng.plan.fwd(rs.cell_i, wrap_shift=None)
    ff = eng.system.params.ff
    F_ext, _ = compute_forces(ext_f, ext_i, eng.layout, ff)
    layers = {"halo fwd (f32 payload)": lambda: eng.plan.fwd(payload),
              "dense forces": lambda: compute_forces(ext_f, ext_i,
                                                     eng.layout, ff),
              "halo rev (f32 forces)": lambda: eng.plan.rev(F_ext)}
    for name, fn in layers.items():
        w, dev, k, b, _ = _profile(fn, n_steps)
        print(f"  layer {name:24s} device {dev / 1e3:.4f} ms "
              f"({dev / device:.4f} of the step's device time), "
              f"{k:.0f} kernels, host wall {w / 1e3:.4f} ms")
    for name, (t, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  kernel {t / device:7.4f} {t:10.2f} us/step {k:7.2f}/step "
              f"{name[:80]}")
    for tag in ("pack_kernel", "unpack_add_kernel"):
        hits = [(t, k) for name, (t, k) in by_name.items() if tag in name
                and (tag == "unpack_add_kernel" or "unpack" not in name)]
        t, k = sum(h[0] for h in hits), sum(h[1] for h in hits)
        if k:
            print(f"  halo {tag}: {k:.2f} launches/step, device "
                  f"{t / k:.3f} us/launch, {t:.2f} us/step")


def main():
    if not (SRC / "repro_torch" / "csrc" / "halo_pack.cu").is_file():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             "repository")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{kind}")

    # 2. build
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build(["halo_pack"])
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for res in built.values():
        for line in res.log.splitlines():
            if any(w in line for w in ("registers", "Compiling entry",
                                       "smem", "spill")):
                print(f"  ptxas {res.name}: {line.strip()}")

    # 3. kernels at the main path's shapes, on the main path's state
    from repro_torch import HaloSpec, MDEngine, make_grappa_like, make_md_mesh
    system = make_grappa_like(45_000, seed=0)
    eng = MDEngine(system, make_md_mesh(8),
                   HaloSpec(AXES, (1, 1, 1), backend="pallas"))
    cf, ci, _force, _diag = eng.rebin_fn(*eng.init_state())
    per_kernel = kernel_phase(eng, cf, ci)
    del eng, cf, ci, _force

    # 4. small reference
    reference_phase()

    # 5. the main path
    launches = main_path_phase()

    # 6. where a steady step spends device time
    profile_phase()

    replaces = {"pack": "src/repro/kernels/halo_pack.py:57",
                "unpack_add": "src/repro/kernels/halo_pack.py:105"}
    kernels = []
    for name, acc in per_kernel.items():
        bound_by = "bytes" if acc["bytes"] / HBM_BPS >= \
            acc["ops"] / FP32_FLOPS else "operations"
        kernels.append({
            "name": f"halo_pack.{name}", "route": "cuda",
            "source": "src/repro_torch/csrc/halo_pack.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": acc["max_abs_err"], "ms": acc["ms"],
            "plain_ms": acc["plain_ms"], "bound_ms": acc["bound_ms"],
            "bound_by": bound_by, "library_ms": acc["library_ms"]})
    print("kernel times are one MD step's f32 launches (pack: 3 fwd + 3 rev "
          "pulses; unpack_add: 3 rev pulses), summed")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
