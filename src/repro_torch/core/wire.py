"""Drift-bounded compressed halo payloads (``HaloSpec.wire_dtype``).

The port of the JAX package's ``core/wire.py``: the one codec seam every
layer shares.

* :class:`WireCodec`: elementwise encode / decode between the payload
  dtype and a wire format.  The two exchange directions compress
  differently (the reference's measurements, kept in
  :data:`MEASURED_DRIFT`):

  - the coordinate (forward) direction has a float32 floor: f64 payloads
    ship f32 coordinates (GROMACS' mixed-precision exchange for
    double-precision trajectories), f32 payloads ship dense;
  - the force-return (reverse) direction carries the named format:
    ``"bfloat16"`` / ``"float16"`` casts, or ``"int8_ef"``,
    per-tensor-scaled int8 with error feedback.  ``"int8"`` (no
    feedback) is the documented over-aggressive format the drift gate
    rejects.

* the int8 helpers (:func:`int8_scale`, :func:`int8_quantize`,
  :func:`int8_dequantize`, :func:`int8_encode`): the scale is taken over
  finite entries only and nonfinite entries quantize to 0, so one NaN
  corrupts only its own slot.

* the build-time drift gate (:func:`gate_wire_config`), with the
  ``verify="warn"`` / ``"off"`` escape hatches of the schedule verifier.

Two differences of form from the reference, neither of value:

* **Per-domain scales.**  The reference takes the int8 scale inside
  ``shard_map``, over one device's whole block.  A block tensor here
  holds every domain in its leading ``n_lead`` dims, so the scale (and
  with it the error-feedback residual) is reduced over the other dims
  only: one scale per domain, kept with the block's rank (shape
  ``(*D, 1, .., 1)``) so that it broadcasts.
* **Casts spelled as XLA rounds.**  :func:`wire_cast` converts with a
  single rounding where XLA rounds once.  PyTorch's float64 -> float16
  cast on the CPU rounds twice (through float32), which differs from
  XLA's at near-ties (``1 + 2**-11 + 2**-40`` gives 1.0 against XLA's
  1.0009765625).  float64 -> bfloat16 rounds through float32 in both
  frameworks, and is spelled so.

Constant divisors are 0-dim tensors of the working dtype: on CUDA,
PyTorch divides by a Python float as a multiply by its reciprocal.
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import const

# recognized wire formats; None (dense) is always legal
WIRE_DTYPES = ("float32", "bfloat16", "float16", "int8_ef", "int8")

# wire bytes per payload element
WIRE_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2,
                 "int8_ef": 1, "int8": 1}

FP_WIRE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

# ---------------------------------------------------------------------------
# drift gate: measured NVE drift per wire format vs the dense-f32 bound
# ---------------------------------------------------------------------------

# the dense-f32 drift level of the reference's NVE harness
# (tests/test_nve_drift.py, DRIFT_BOUND there); a compressed exchange must
# stay at this level to be accepted
DENSE_F32_DRIFT_BOUND = 1.5e-3

# the reference's CPU measurements of energy drift (tests/test_nve_drift.py:
# float64 two-slab system, 200 steps, drift = (E.max - E.min) / n_atoms,
# fused backend; dense measures 3.4e-4).  All formats ship f32-floor
# coordinates; the named format applies to the force return.
MEASURED_DRIFT = {
    "float32": 3.4e-4,
    "bfloat16": 3.2e-4,
    "float16": 3.4e-4,
    "int8_ef": 4.3e-4,
    "int8": 3.0e-3,       # no feedback: bias accumulates -> rejected
}

VERIFY_MODES = ("error", "warn", "off")


class WireDriftError(ValueError):
    """A wire format whose measured NVE drift exceeds the dense-f32 bound."""


def gate_wire_config(wire_dtype: Optional[str], verify: str = "error",
                     bound: float = DENSE_F32_DRIFT_BOUND
                     ) -> Optional[float]:
    """Build-time acceptance gate for a compressed-halo config.

    Returns the measured drift for ``wire_dtype`` (None for dense).
    Raises :class:`WireDriftError` when that drift exceeds ``bound``
    (``verify="warn"`` downgrades to a ``RuntimeWarning``, ``"off"``
    skips), and ``ValueError`` for unknown formats whatever ``verify``.
    """
    if verify not in VERIFY_MODES:
        raise ValueError(f"unknown verify mode {verify!r}; "
                         f"available: {VERIFY_MODES}")
    if wire_dtype is None:
        return None
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"unknown wire_dtype {wire_dtype!r}; "
                         f"available: {WIRE_DTYPES} or None")
    if verify == "off":
        return MEASURED_DRIFT[wire_dtype]
    drift = MEASURED_DRIFT[wire_dtype]
    if drift > bound:
        msg = (f"wire_dtype={wire_dtype!r}: measured NVE drift "
               f"{drift:.2e}/atom exceeds the dense-f32 bound "
               f"{bound:.2e} (tests/test_nve_drift.py harness); this "
               "config corrupts trajectories and is rejected at build "
               "time.  Use 'int8_ef' (error feedback) or a 16-bit wire "
               "format, or pass verify='warn' to measure it anyway.")
        if verify == "warn":
            warnings.warn(msg, RuntimeWarning, stacklevel=3)
        else:
            raise WireDriftError(msg)
    return drift


# ---------------------------------------------------------------------------
# casts as XLA rounds them
# ---------------------------------------------------------------------------

def _f64_to_f16(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float16 with one rounding to nearest even.

    Rounds to float32 by round-to-odd first (truncate toward zero, then
    set the last bit where the cast was inexact): float32 keeps 13 bits
    more than float16, so the second rounding then lands where a single
    rounding of the float64 value would.
    """
    y = x.to(torch.float32)
    back = y.to(torch.float64)
    bits = y.view(torch.int32)
    # one f32 ulp back toward zero where round-to-nearest went away from it
    bits = torch.where(back.abs() > x.abs(), bits - 1, bits)
    bits = torch.where((back != x) & torch.isfinite(x), bits | 1, bits)
    return bits.view(torch.float32).to(torch.float16)


def wire_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.astype(dtype)`` as XLA computes it: one rounding, except
    float64 -> bfloat16, which XLA rounds through float32."""
    if x.dtype == torch.float64:
        if dtype == torch.float16:
            return _f64_to_f16(x)
        if dtype == torch.bfloat16:
            return x.to(torch.float32).to(torch.bfloat16)
    return x.to(dtype)


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return int(np.dtype(dtype).itemsize)


# ---------------------------------------------------------------------------
# int8 quantize / dequant helpers
# ---------------------------------------------------------------------------

def _lead_dims(x: torch.Tensor, n_lead: int) -> Tuple[int, ...]:
    return tuple(range(n_lead, x.dim()))


def int8_scale(x: torch.Tensor, n_lead: int = 0) -> torch.Tensor:
    """Per-tensor (per-domain over the first ``n_lead`` dims) int8 scale:
    ``max(|x|) / 127 + 1e-12`` over finite entries, shaped to broadcast
    against ``x``.  A zero (or all-nonfinite) tensor gets the epsilon
    scale, which quantizes everything to 0."""
    finite = torch.where(torch.isfinite(x), x, const(0.0, x.dtype, x.device))
    amax = torch.amax(finite.abs(), dim=_lead_dims(x, n_lead), keepdim=True)
    return (amax / const(127.0, x.dtype, x.device)
            + const(1e-12, x.dtype, x.device))


def int8_quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Round / clip to int8 at ``scale``; nonfinite entries quantize to 0."""
    q = torch.where(torch.isfinite(x), torch.round(x / scale),
                    const(0.0, x.dtype, x.device))
    return torch.clamp(q, -127, 127).to(torch.int8)


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return q.to(dtype) * scale.to(dtype)


def int8_encode(x: torch.Tensor, n_lead: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize plus the error-feedback residual: ``(q, scale, err)``,
    ``err`` the finite part of ``x - dequant(q)``."""
    scale = int8_scale(x, n_lead)
    q = int8_quantize(x, scale)
    err = torch.where(torch.isfinite(x), x, const(0.0, x.dtype, x.device)) \
        - int8_dequantize(q, scale, x.dtype)
    return q, scale, err


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

class WireCodec:
    """Elementwise wire-format codec for one ``HaloSpec.wire_dtype``.

    ``encode`` / ``decode`` / ``roundtrip`` are the force-return
    (reverse) direction: the named format, with error feedback for
    ``int8_ef``.  ``fwd_roundtrip`` is the coordinate (forward)
    direction: the float32 floor whatever the named format.  ``n_lead``
    is the number of leading domain dims of the tensors it codes (the
    int8 scale is one per domain).
    """

    def __init__(self, name: str, n_lead: int = 0):
        if name not in WIRE_DTYPES:
            raise ValueError(f"unknown wire_dtype {name!r}; "
                             f"available: {WIRE_DTYPES} or None")
        self.name = name
        self.n_lead = int(n_lead)
        self.wire_itemsize = WIRE_ITEMSIZE[name]
        self.is_float = name in FP_WIRE
        self.tdtype = FP_WIRE.get(name)
        # stateful formats thread EF tensors through the caller's loop
        self.stateful = name == "int8_ef"

    @staticmethod
    def fwd_itemsize(payload_dtype) -> int:
        """Coordinate-direction wire bytes per element: the float32 floor."""
        return min(4, _itemsize(payload_dtype))

    @staticmethod
    def fwd_wire_dtype(payload_dtype) -> Optional[str]:
        """Coordinate-direction wire dtype, or None when the payload
        already sits at (or below) the float32 floor and rides dense."""
        if _itemsize(payload_dtype) > 4:
            return "float32"
        return None

    def fwd_roundtrip(self, x: torch.Tensor) -> torch.Tensor:
        """Wire-grid a coordinate payload: an f32 cast for wide payloads,
        identity at or below the floor."""
        if self.fwd_wire_dtype(x.dtype) is None:
            return x
        return x.to(torch.float32).to(x.dtype)

    def encode(self, x: torch.Tensor, ef: Optional[torch.Tensor] = None):
        """``(parts, new_ef)``: the wire-dtyped tensor (plus the scale for
        int8), and the new error-feedback residual (int8_ef with ``ef``)."""
        if self.is_float:
            return (wire_cast(x, self.tdtype),), ef
        comp = x if ef is None else x + ef
        if ef is None:
            scale = int8_scale(comp, self.n_lead)
            return (int8_quantize(comp, scale), scale), None
        q, scale, err = int8_encode(comp, self.n_lead)
        return (q, scale), err

    def decode(self, parts, dtype) -> torch.Tensor:
        if self.is_float:
            return parts[0].to(dtype)
        q, scale = parts
        return int8_dequantize(q, scale, dtype)

    def roundtrip(self, x: torch.Tensor, ef: Optional[torch.Tensor] = None):
        """``decode(encode(x))``: the wire-gridded payload (and new EF)."""
        parts, new_ef = self.encode(x, ef)
        return self.decode(parts, x.dtype), new_ef

    def part_shapes(self, shape, dtype):
        """(shape, dtype) of ``encode``'s parts for a payload shape."""
        shape = tuple(shape)
        if self.is_float:
            return ((shape, self.tdtype),)
        scale = shape[:self.n_lead] + (1,) * (len(shape) - self.n_lead)
        return ((shape, torch.int8), (scale, dtype))

    def __repr__(self):
        return f"WireCodec({self.name!r})"


def make_codec(wire_dtype: Optional[str],
               n_lead: int = 0) -> Optional[WireCodec]:
    """Codec for a spec's ``wire_dtype`` (None = dense, no codec)."""
    if wire_dtype is None:
        return None
    return WireCodec(wire_dtype, n_lead)
