"""Carry state between the JAX reference and the port, in both directions.

* :func:`system_from_jax` — a reference ``MDSystem`` (read by its fields,
  never imported) as the port's dataclass, arrays as numpy.
* :func:`cells_to_domains` / :func:`domains_to_cells` — the reference's
  stacked global cell arrays ``(Dz*cz, Dy*cy, Dx*cx, K, F)`` (sharded
  ``P("z", "y", "x")``: domain ``(i, j, k)`` owns block ``(i, j, k)``)
  against the port's domain-leading ``(Dz, Dy, Dx, cz, cy, cx, K, F)``.

Both layout functions take numpy arrays or torch tensors.

* :func:`lm_params_from_jax` — a reference LM's parameter tree (leaves as
  numpy arrays, or anything ``numpy.asarray`` takes) as the port's
  ``LM`` state dict; :func:`lm_params_to_jax` the reverse, the reference's
  stacked tree of host tensors.
* :func:`adamw_state_to_jax` / :func:`adamw_state_from_jax` — the port's
  AdamW state (moments keyed by parameter name) against the reference's
  ``{"step", "m", "v"}`` of stacked trees.

The training checkpoints hold the reference's trees, so each package
resumes the other's runs.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.md.system import ForceField, MDParams, MDSystem


def system_from_jax(system) -> MDSystem:
    """The port's :class:`MDSystem` with the same arrays and parameters."""
    p, ff = system.params, system.params.ff
    return MDSystem(
        box=np.array(system.box), pos=np.array(system.pos),
        vel=np.array(system.vel), charge=np.array(system.charge),
        typ=np.array(system.typ),
        params=MDParams(
            ff=ForceField(eps=tuple(map(tuple, ff.eps)),
                          sigma=tuple(map(tuple, ff.sigma)),
                          r_cut=ff.r_cut, eps_rf=ff.eps_rf),
            dt=p.dt, mass=p.mass, nstlist=p.nstlist,
            temperature=p.temperature))


def _permute(x, axes):
    return x.permute(*axes) if isinstance(x, torch.Tensor) \
        else np.transpose(x, axes)


def _global_to_domains(x, mesh_shape: Sequence[int]):
    Dz, Dy, Dx = mesh_shape
    Gz, Gy, Gx = x.shape[:3]
    if Gz % Dz or Gy % Dy or Gx % Dx:
        raise ValueError(f"global cells {(Gz, Gy, Gx)} do not split over "
                         f"mesh {tuple(mesh_shape)}")
    tail = tuple(x.shape[3:])
    x = x.reshape((Dz, Gz // Dz, Dy, Gy // Dy, Dx, Gx // Dx) + tail)
    nt = len(tail)
    return _permute(x, (0, 2, 4, 1, 3, 5) + tuple(range(6, 6 + nt)))


def _domains_to_global(x):
    Dz, Dy, Dx, cz, cy, cx = x.shape[:6]
    tail = tuple(x.shape[6:])
    nt = len(tail)
    x = _permute(x, (0, 3, 1, 4, 2, 5) + tuple(range(6, 6 + nt)))
    return x.reshape((Dz * cz, Dy * cy, Dx * cx) + tail)


def cells_to_domains(cell_f_global, cell_i_global, mesh_shape):
    """Stacked global cell arrays -> domain-leading block arrays."""
    return (_global_to_domains(cell_f_global, mesh_shape),
            _global_to_domains(cell_i_global, mesh_shape))


def domains_to_cells(cell_f, cell_i):
    """Domain-leading block arrays -> stacked global cell arrays."""
    return _domains_to_global(cell_f), _domains_to_global(cell_i)


def lm_params_from_jax(params) -> dict:
    """The reference ``LM``'s params as the port's ``LM.state_dict()``.

    The reference stacks each unit leaf as ``(n_units, ...)`` under
    ``units/layer{i}``; the port holds layer ``u * P + i`` (``P`` layers
    per unit) in ``layers.{u * P + i}``.  Other leaves keep their names.
    """
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, prefix + (k,))
            else:
                yield prefix + (k,), np.asarray(v)

    units = params["units"]
    P = len(units)
    for path, leaf in walk(units, ()):
        i = int(path[0][len("layer"):])
        for u in range(leaf.shape[0]):
            out[".".join((f"layers.{u * P + i}",) + path[1:])] = \
                torch.from_numpy(np.array(leaf[u]))
    for path, leaf in walk({k: v for k, v in params.items()
                            if k != "units"}, ()):
        out[".".join(path)] = torch.from_numpy(np.array(leaf))
    return out


def lm_params_to_jax(state: dict, layers_per_unit: int) -> dict:
    """The port's LM state (``name -> tensor``, e.g. ``named_parameters``)
    as the reference's parameter tree of host tensors: layer
    ``u * layers_per_unit + i``'s leaves stacked along dim 0 of
    ``units/layer{i}``, every other leaf under its dotted path."""
    P = layers_per_unit
    layers: dict = {}
    out: dict = {}
    for name, t in state.items():
        t = t.detach().cpu()
        path = name.split(".")
        if path[0] == "layers":
            n = int(path[1])
            layers.setdefault((n % P,) + tuple(path[2:]), {})[n // P] = t
            continue
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    units = out.setdefault("units", {})
    for (i, *rest), by_unit in sorted(layers.items()):
        node = units.setdefault(f"layer{i}", {})
        for k in rest[:-1]:
            node = node.setdefault(k, {})
        node[rest[-1]] = torch.stack([by_unit[u] for u in range(len(by_unit))])
    return out


def adamw_state_to_jax(opt_state: dict, layers_per_unit: int) -> dict:
    """The port's AdamW state as the reference's: ``step`` (int32 0-dim)
    and the moments as stacked trees, all host tensors."""
    return {"step": opt_state["step"].detach().cpu(),
            "m": lm_params_to_jax(opt_state["m"], layers_per_unit),
            "v": lm_params_to_jax(opt_state["v"], layers_per_unit)}


def adamw_state_from_jax(tree, device=None) -> dict:
    """The reference's AdamW state as the port's, on ``device``."""
    def on(t):
        return t.to(device) if device is not None else t
    return {"step": on(torch.as_tensor(np.asarray(tree["step"]),
                                       dtype=torch.int32)),
            "m": {k: on(v) for k, v in lm_params_from_jax(tree["m"]).items()},
            "v": {k: on(v) for k, v in lm_params_from_jax(tree["v"]).items()}}
