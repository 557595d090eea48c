"""The port stands alone: no JAX, no reference package, no silent CPU."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import BatchServer, build_model, get_config
from repro_torch.core.halo_plan import HaloPlan, HaloSpec
from repro_torch.core.md import MDEngine, make_grappa_like
from repro_torch.launch import serve as serve_launch
from repro_torch.launch.mesh import make_mesh

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                yield "<relative>"
            elif node.module:
                yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "id", "") == "__import__" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    assert path.exists(), path
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN + ("<relative>",)))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_port_imports_and_steps_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import repro_torch\n"
        "from repro_torch import MDEngine, HaloSpec, make_mesh, "
        "make_grappa_like\n"
        "eng = MDEngine(make_grappa_like(300, seed=11), "
        "make_mesh((1, 1, 1), ('z', 'y', 'x')), "
        "HaloSpec(('z', 'y', 'x'), (1, 1, 1), backend='pallas'), "
        "device='cpu')\n"
        "_, m, d = eng.simulate(2)\n"
        "assert m['pe'].shape == (2,) and d[0]['n_atoms'] == 300\n"
        "eng = MDEngine(make_grappa_like(300, seed=11), "
        "make_mesh((1, 1, 1), ('z', 'y', 'x')), "
        "HaloSpec(('z', 'y', 'x'), (1, 1, 1), backend='pallas'), "
        "force_backend='pallas', nstprune=1, device='cpu')\n"
        "_, m, d = eng.simulate(2)\n"
        "assert m['pe'].shape == (2,) and eng.sched_history\n"
        "eng = MDEngine(make_grappa_like(300, seed=11), "
        "make_mesh((1, 1, 1), ('z', 'y', 'x')), "
        "HaloSpec(('z', 'y', 'x'), (1, 1, 1), backend='signal'), "
        "pipeline='double_buffer', pipeline_depth=3, overlap_rebin=True, "
        "device='cpu')\n"
        "rs = eng.begin_run()\n"
        "m = eng.run_block(rs, 3, fuse=True)\n"
        "assert m['pe'].shape == (3,) and len(rs.diags) == 2\n"
        "assert eng.schedule_report.safe\n"
        "import numpy as np, torch\n"
        "from repro_torch import BatchServer, build_model, get_config\n"
        "from repro_torch.runtime.serve_loop import Request\n"
        "lm = build_model(get_config('qwen3-1.7b').reduce(), device='cpu')"
        ".init(torch.Generator().manual_seed(0))\n"
        "out = BatchServer(lm, batch_size=2, max_len=12).serve_wave("
        "[Request(prompt=np.arange(1, 6, dtype=np.int32), "
        "max_new_tokens=3)])\n"
        "assert out[0].out_tokens.shape == (3,)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.')) "
        "for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env={"PYTHONPATH": str(REPO / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_entry_points_default_to_cuda_and_never_fall_back():
    system = make_grappa_like(300, seed=11)
    mesh = make_mesh((1, 1, 1), ("z", "y", "x"))
    spec = HaloSpec(("z", "y", "x"), (1, 1, 1), backend="pallas")
    if torch.cuda.is_available():
        assert MDEngine(system, mesh, spec).device.type == "cuda"
        assert HaloPlan.build(spec, mesh).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        MDEngine(system, mesh, spec)
    with pytest.raises(RuntimeError, match="cuda"):
        HaloPlan.build(spec, mesh)
    with pytest.raises(RuntimeError, match="cuda"):
        MDEngine(system, mesh, spec, device="cuda:0")


def test_lm_entry_points_default_to_cuda_and_never_fall_back():
    cfg = get_config("qwen3-1.7b").reduce()
    argv = ["--arch", "qwen3-1.7b", "--reduced", "--requests", "1",
            "--new-tokens", "1"]
    if torch.cuda.is_available():
        model = build_model(cfg)
        assert model.device.type == "cuda"
        assert BatchServer(model, 1, 16).rng.device.type == "cuda"
        assert serve_launch.main(argv)[0].out_tokens.shape == (1,)
        return
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        serve_launch.main(argv)
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg, device="cuda:0")
