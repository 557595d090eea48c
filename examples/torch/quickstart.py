"""Quickstart on the card: the paper's fused halo exchange, PyTorch port.

``examples/quickstart.py`` on one GPU: the domains of a virtual mesh
(``--domains``, factored into (Z, Y, X) as the reference factors its
devices) are leading tensor dims.  Runs a grappa-like MD system with the
serialized (MPI-flavored) and fused (NVSHMEM-flavored) halo backends, and
shows the plan-based N-D halo exchange on a plain tensor, its gradient and
the plan's byte accounting.

  PYTHONPATH=src python examples/torch/quickstart.py
  PYTHONPATH=src python examples/torch/quickstart.py --device cpu
"""
import argparse

import torch

from repro_torch import HaloPlan, HaloSpec, MDEngine, make_grappa_like
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_md_mesh


def main(n_atoms=1200, steps=20, n_domains=8, device="cuda"):
    dev = resolve_device(device)
    # --- plan-based halo exchange on a dense grid ---------------------------
    mesh = make_md_mesh(n_domains)       # factors the domains into (Z, Y, X)
    print(f"domain mesh: {mesh.shape} on {dev}")
    Z = mesh.shape["z"]
    x = torch.arange(float(8 * Z * 8 * 4), device=dev).reshape(Z, 8, 8, 4)
    plan = HaloPlan.build(HaloSpec(axis_names=("z",), widths=(2,),
                                   backend="fused"), mesh, device=dev)
    ext = plan.fwd(x)
    print(f"halo exchange: {(8 * Z, 8, 4)} -> "
          f"{(ext.shape[0] * ext.shape[1],) + tuple(ext.shape[2:])} "
          "(per-dim +width*shards)")
    # plan.exchange is differentiable: its backward is the fused force-return
    xg = x.clone().requires_grad_()
    (plan.exchange(xg) ** 2).sum().backward()
    print(f"grad through plan.exchange: {tuple(xg.grad.shape)} "
          "(fused reverse path)")

    # --- the MD reproduction ------------------------------------------------
    system = make_grappa_like(n_atoms, seed=0)
    print(f"grappa-like system: {system.n_atoms} atoms, "
          f"box {system.box[0]:.2f}")
    energy = {}
    for backend in ("serialized", "fused"):
        spec = HaloSpec(axis_names=("z", "y", "x"), widths=(1, 1, 1),
                        backend=backend)
        eng = MDEngine(system, mesh, spec, device=dev)
        _, metrics, _ = eng.simulate(steps)
        E = energy[backend] = metrics["pe"] + metrics["ke"]
        print(f"{backend:11s}: E0={E[0]:9.3f}  E{steps}={E[-1]:9.3f}  "
              f"drift/atom={(E.max() - E.min()) / system.n_atoms:.2e}")

    # --- what the fused schedule buys (napkin math from the plan) -----------
    md_plan = HaloPlan.build(
        HaloSpec(axis_names=("z", "y", "x"), widths=(1, 1, 1),
                 dtype="float32", feature_elems=4), mesh, device=dev)
    stats = md_plan.stats((8, 8, 8))
    print(f"total halo bytes:         {stats['total_bytes']}")
    print(f"serialized chained bytes: {stats['serialized_critical_bytes']}")
    print(f"fused chained bytes:      {stats['fused_critical_bytes']} "
          f"({stats['fused_critical_bytes'] / stats['serialized_critical_bytes']:.0%})")
    print(f"dependent fraction:       {stats['dependent_fraction']:.3%}")

    # --- and what a compressed wire buys on top (HaloSpec.wire_dtype) -------
    wire_plan = HaloPlan.build(
        HaloSpec(axis_names=("z", "y", "x"), widths=(1, 1, 1),
                 dtype="float32", feature_elems=4, wire_dtype="bfloat16"),
        mesh, device=dev)
    ws = wire_plan.stats((8, 8, 8))
    print(f"wire=bfloat16 bytes:      {ws['wire_bytes']} "
          f"({ws['wire_reduction']:.2f}x fewer than dense both ways)")
    return stats, ws, energy


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--atoms", type=int, default=1200)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--domains", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(n_atoms=a.atoms, steps=a.steps, n_domains=a.domains,
         device=a.device)
