"""The conformance-matrix config grids, as verifier inputs.

The port's copy of the JAX package's ``analysis/grids.py``, mirroring
the runtime grids of the conformance tests (``tests/test_pipeline.py``
for the reference, ``tests/test_torch_pipeline.py`` for the port):

* :func:`pr4_grid` — backend x pipeline mode x halo width x window depth
  (the 48-cell cross-backend conformance matrix, 8-step blocks);
* :func:`pr5_prune_grid` — the dual-pair-list axis: nstprune x
  (mode, depth, overlap_rebin) over 20-step (nstlist) blocks on the
  3-D signal backend with the sparse force engine.

Every cell must verify as statically safe.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.analysis.schedule_verifier import ScheduleConfig

MATRIX_BACKENDS = ("serialized", "fused", "pallas", "signal")
MATRIX_MODES = ("off", "double_buffer")
MATRIX_WIDTHS = (1, 2)
MATRIX_DEPTHS = (2, 3, 4)
MATRIX_STEPS = 8

PRUNE_NSTPRUNE = (0, 4)
PRUNE_CELLS = (
    ("off", 2, False),
    ("double_buffer", 2, False),
    ("double_buffer", 3, False),
    ("off", 2, True),
    ("double_buffer", 3, True),
)
PRUNE_STEPS = 20          # the engine's nstlist block length


def pr4_grid() -> Tuple[ScheduleConfig, ...]:
    """The 48-cell cross-backend conformance matrix as schedule configs."""
    cells = []
    for backend in MATRIX_BACKENDS:
        for mode in MATRIX_MODES:
            for width in MATRIX_WIDTHS:
                for depth in MATRIX_DEPTHS:
                    cells.append(ScheduleConfig.from_spec(
                        ("z",), (width,), backend=backend, mode=mode,
                        depth=depth, n_steps=MATRIX_STEPS))
    return tuple(cells)


def pr5_prune_grid() -> Tuple[ScheduleConfig, ...]:
    """The dual-pair-list prune axis as schedule configs."""
    cells = []
    for nstprune in PRUNE_NSTPRUNE:
        for mode, depth, ovr in PRUNE_CELLS:
            cells.append(ScheduleConfig.from_spec(
                ("z", "y", "x"), (1, 1, 1), backend="signal", mode=mode,
                depth=depth, n_steps=PRUNE_STEPS, nstprune=nstprune,
                overlap_rebin=ovr, force_backend="sparse"))
    return tuple(cells)


def full_grid() -> Tuple[ScheduleConfig, ...]:
    return pr4_grid() + pr5_prune_grid()
