"""PyTorch/CUDA port of the halo-exchange MD engine (its replica server,
and the LM serving path) for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package never imports
it (nor JAX).  Entry points run on ``device="cuda"`` unless the caller
asks for the CPU, and raise when CUDA is absent.
"""
from repro_torch.configs import get_config
from repro_torch.core.halo_plan import HaloPlan, HaloSpec
from repro_torch.core.md.engine import MDEngine
from repro_torch.core.md.system import make_grappa_like
from repro_torch.launch.mesh import DomainMesh, make_md_mesh, make_mesh
from repro_torch.models import build_model
from repro_torch.runtime.serve_loop import BatchServer
from repro_torch.serve import BucketLadder, SimServer

__all__ = ["HaloPlan", "HaloSpec", "MDEngine", "make_grappa_like",
           "DomainMesh", "make_md_mesh", "make_mesh", "build_model",
           "get_config", "BatchServer", "BucketLadder", "SimServer"]
