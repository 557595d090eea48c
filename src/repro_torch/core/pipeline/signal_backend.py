"""The ``"signal"`` halo backend: fused pack + put-with-signal pulses.

The port of the JAX package's ``core/pipeline/signal_backend.py``, the
end-to-end consumer of the two kernels the paper's GPU-initiated
redesign is built from (:mod:`repro_torch.kernels.halo_pack`):

* single-pulse dims run ``put_signal(shift=-1)``: the fused pack + put
  whose arrival word is the data signal (paper Alg. 3/5); with an f64
  payload under a wire format the put ships f32 rows (its converting
  form, B3w) and the receiver casts them back;
* multi-pulse dims (``HaloSpec.pulses``) run ``fused_pulses``: one launch
  per dim, the pulses chained through their arrival words (Alg. 4); they
  always ship dense, as in the reference (staged forwarding would
  re-round at every hop);
* the reverse (force-return) path runs ``put_signal(shift=+1)`` per pulse
  in reversed serialized order, then a slab add (Alg. 6's CommUnpackF in
  its canonical form), so it launches no ``unpack_add``.

On a CUDA block the kernels run or raise; on a CPU block their plain
forms run (the reference's jnp oracle with the kernels' semantics).  The
port has no fallback latch.  Index maps are static per local shape and
cached on the plan, as are the signal words: one set per ledger slot of
the step pipeline (``slot``, the step's ``k % depth``; ``off`` uses slot
0 only), each ``put_signal``'s two words per domain followed, where a
dim has several pulses, by ``fused_pulses``' two per (domain, pulse) and
its ticket.  Every launch resets the words it uses on the stream, so the
launches of one slot, which run in stream order, share a set; launches
of two slots never share a word or a ticket.

Like the other backends this one ships one hop per pulse, so halo widths
must not exceed the local block (``w <= n``); multi-pulse splits of such
widths are supported.

On a lane plan (:meth:`~repro_torch.core.halo_plan.HaloPlan.with_lanes`)
the kernels ring over the ``(lanes, *domains)`` mesh along axis
``1 + d``, so no put crosses a lane, and the words are sized for every
lane's domains; the kernels are the same.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import halo as _halo
from repro_torch.core.halo_plan import PallasBackend, register_backend
from repro_torch.kernels import halo_pack


class SignalBackend(PallasBackend):
    """Put-with-signal exchange over :mod:`repro_torch.kernels.halo_pack`."""

    name = "signal"
    # pack / put / signal are fused per pulse and the phases overlap: the
    # fused critical-path model describes this backend
    critical_path = "fused"

    def _words(self, plan, slot: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Ledger slot ``slot``'s signal words, allocated at the slot's
        first launch: ``(put_signal's, fused_pulses')``, two views of one
        buffer.  ``put_signal`` takes two per domain (arrival words, then
        counters); where a dim has several pulses ``fused_pulses`` takes
        an arrival word and a counter per (domain, pulse of the longest
        dim) plus its ticket, else none."""
        key = ("signal_words", int(slot))
        words = plan._index_maps.get(key)
        if words is None:
            n_pulses = max(len(plan.sched.dim_pulses(d))
                           for d in range(plan.spec.ndim))
            n_dom = math.prod(plan.block_dims)
            fused = halo_pack.fused_pulses_words(n_dom, n_pulses) \
                if n_pulses > 1 else 0
            buf = torch.zeros((2 * n_dom + fused,), dtype=torch.int32,
                              device=plan.device)
            words = (buf[:2 * n_dom], buf[2 * n_dom:])
            plan._index_maps[key] = words
        return words

    # -- per-dim forward index maps (cached on the plan) -------------------

    def _dim_fwd_maps(self, plan, local_shape: Tuple[int, ...]):
        key = ("signal_fwd", local_shape)
        cached = plan._index_maps.get(key)
        if cached is not None:
            return cached
        shape = list(local_shape)
        per_dim = []
        for d in range(plan.spec.ndim):
            pulses = plan.sched.dim_pulses(d)
            w_total = plan.sched.widths[d]
            if w_total == 0:
                per_dim.append(None)
                continue
            if w_total > shape[d]:
                raise NotImplementedError(
                    f"signal backend: dim {d} halo width {w_total} exceeds "
                    f"the local block ({shape[d]}); multi-hop forwarding "
                    "(w > n) is not implemented")
            maps = [self._rows_along(shape, d, p.offset, p.offset + p.width)
                    for p in pulses]
            m_max = max(m.shape[0] for m in maps)
            padded = np.full((len(maps), m_max), -1, np.int32)
            for k, m in enumerate(maps):
                padded[k, :m.shape[0]] = m
            # the kernels trust the maps (an index past the block traps
            # them), so check them once here, on the host
            n_rows = math.prod(shape[:d + 1])
            if padded.max() >= n_rows:
                raise ValueError(f"signal index map for dim {d} of local "
                                 f"shape {tuple(shape)} leaves "
                                 f"[0, {n_rows})")
            per_dim.append((torch.as_tensor(padded, device=plan.device),
                            tuple(m.shape[0] for m in maps)))
            shape[d] += w_total
        plan._index_maps[key] = tuple(per_dim)
        return plan._index_maps[key]

    # -- exchange ----------------------------------------------------------

    def fwd(self, plan, local, wrap_shift, slot=0):
        sched = plan.sched
        nd = plan.n_lead
        local_shape = tuple(local.shape[nd:nd + plan.spec.ndim])
        words, fused_words = self._words(plan, slot)
        per_dim = self._dim_fwd_maps(plan, local_shape)
        # the wire path shifts after the exchange, as the pallas one does
        wire = self._fwd_wire(plan, local)
        shifter = _halo._Shifter(plan.axis_sizes,
                                 wrap_shift if wire is None else None,
                                 plan.lead)
        mesh, lead = plan.block_dims, plan.lead
        ext = local
        for d in range(plan.spec.ndim):
            if per_dim[d] is None:
                continue
            padded, counts = per_dim[d]
            pulses = sched.dim_pulses(d)
            shape = ext.shape
            src = self._rows2d(ext, nd, d)
            if len(pulses) == 1:
                recvs = [_halo.delivered(halo_pack.put_signal(
                    src, padded[0, :counts[0]], mesh, lead + d, -1,
                    signal=words, wire_dtype=wire)).to(ext.dtype)]
            else:
                out = halo_pack.fused_pulses(src, padded, src.shape[1],
                                             mesh, lead + d,
                                             words=fused_words)
                # the rows each pulse's map names, not the padding rows
                recvs = [_halo.delivered(out[:, k, :counts[k]])
                         for k in range(len(pulses))]
            for pulse, rows in zip(pulses, recvs):
                slab = rows.reshape(shape[:nd + d] + (pulse.width,)
                                    + shape[nd + d + 1:])
                ext = torch.cat([ext, shifter(slab, d)], dim=nd + d)
        if wire is not None:
            ext = self._shift_halos(plan, ext, wrap_shift, local_shape)
        return ext

    def rev(self, plan, ext, slot=0):
        sched = plan.sched
        nd = plan.n_lead
        words, _ = self._words(plan, slot)
        _, rev_maps = self._maps(plan, self._local_shape(plan, ext))
        out = ext
        for pulse, maps in zip(reversed(sched.serialized_order()), rev_maps):
            if maps is None:
                continue
            d, w, off = pulse.dim, pulse.width, pulse.offset
            shape = out.shape
            # fused pack + put to the +1 neighbour: the force-return pulse
            recv = _halo.delivered(halo_pack.put_signal(
                self._rows2d(out, nd, d), maps.pack_idx, plan.block_dims,
                plan.lead + d, +1, signal=words))
            body = out.narrow(nd + d, 0, shape[nd + d] - w)
            # unpack as a slab accumulate, as the reference does
            slab = recv.reshape(shape[:nd + d] + (w,) + shape[nd + d + 1:])
            out = _halo._add_at(body, nd + d, off, w, slab)
        return out


register_backend("signal", SignalBackend)
