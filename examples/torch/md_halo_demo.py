"""Strong-scaling flavor demo on the card: serialized vs fused halo time.

``examples/md_halo_demo.py`` on one GPU: the same system on more domains
of a virtual mesh (``--domains``, one run each), ms a step of the
serialized and the fused halo backends.  Each clock read follows a
``torch.cuda.synchronize()`` (CUDA launches return before the work ends),
and the times are printed with the card's name and power limit.

  PYTHONPATH=src python examples/torch/md_halo_demo.py --domains 1 2 4 8

``--wire bfloat16`` runs each backend with compressed halo payloads (see
README "Compressed halo payloads").
"""
import argparse
import time

import torch

from repro_torch import HaloSpec, MDEngine, make_grappa_like
from repro_torch.device import card_label, resolve_device
from repro_torch.launch.mesh import make_md_mesh


def main(n_atoms=2400, warmup=60, steps=40, wire_dtype=None, n_domains=8,
         device="cuda"):
    """Seconds a step of each backend: ``{"serialized": s, "fused": s}``.
    ``warmup``: untimed steps first; three nstlist = 20 blocks cover the
    two eager calls and the capture of every step and rebin graph."""
    dev = resolve_device(device)
    system = make_grappa_like(n_atoms, seed=1)
    mesh = make_md_mesh(n_domains)
    print(f"{n_domains} domains -> DD grid {mesh.shape} on "
          f"{card_label(dev)}")

    results = {}
    for backend in ("serialized", "fused"):
        spec = HaloSpec(axis_names=("z", "y", "x"), widths=(1, 1, 1),
                        backend=backend)
        eng = MDEngine(system, mesh, spec, wire_dtype=wire_dtype,
                       device=dev)
        cuda = dev.type == "cuda"
        state, _, _ = eng.simulate(warmup, collect=False)
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, metrics, _ = eng.simulate(steps, state=state)
        if cuda:
            torch.cuda.synchronize(dev)
        dt = (time.perf_counter() - t0) / steps
        results[backend] = dt
        wire = f" wire={wire_dtype}" if wire_dtype else ""
        print(f"{backend:11s}{wire}: {dt * 1e3:7.2f} ms/step "
              f"({system.n_atoms / dt / 1e6:.2f} Matom-steps/s)")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--atoms", type=int, default=2400)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--domains", type=int, nargs="+", default=[8])
    ap.add_argument("--wire", default=None,
                    help="wire_dtype for compressed halo payloads "
                         "(e.g. bfloat16)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    for n in a.domains:
        main(n_atoms=a.atoms, steps=a.steps, wire_dtype=a.wire, n_domains=n,
             device=a.device)
