"""Recomputation of a training unit under the reference's two policies.

``checkpoint(fn, *args, policy=)`` runs ``fn`` under
``torch.utils.checkpoint.checkpoint`` (non-reentrant):

* ``"nothing"`` (``jax.checkpoint_policies.nothing_saveable``): only the
  inputs are kept, the backward reruns the whole forward;
* ``"dots"`` (``dots_with_no_batch_dims_saveable``): the outputs of the
  unit's matrix products that have no batch dims are kept as well, and
  the backward recomputes everything else from them.

What ``"dots"`` keeps is decided by what a product means, not by its aten
name.  A 2-D weight applied to an activation folds into ``aten.mm`` (or
``addmm``), but PyTorch leaves it an ``aten.bmm`` over a weight expanded
with batch stride 0 when it does not fold (a strided activation and a
weight that needs no grad); a ``bmm`` whose operands both vary along the
batch (attention's einsums, the experts' product) has batch dims and is
recomputed.  Work outside aten (the kernels' ctypes launches) is not seen:
B7 runs again in the recompute, as under ``"nothing"``.

Like the reference's residuals, a product is kept only where the backward
reads it: :class:`_Dots` follows each product's output through the
unit's aten ops and drops it when it reaches the unit's outputs through
ops whose backward reads no operand (adds, views, casts, copies) and
nothing else reads it, such as the last down projection that is only
added into the unit's output.  An op under ``no_grad`` (inside an
``autograd.Function``'s forward, which may save what it reads) counts as
a reader, and so does a product whose use is not seen at all, so the rule
can keep more than needed but never drops what the backward reads.  The
kept products are handed back in the recompute, unchanged (a product
written in place after it was kept raises).
"""
from __future__ import annotations

import torch
from torch.utils import checkpoint as _ckpt
from torch.utils._python_dispatch import TorchDispatchMode

POLICIES = ("nothing", "dots")

_aten = torch.ops.aten
# ops whose backward reads none of their operands' values
_LINEAR = {
    _aten.add.Tensor, _aten.add_.Tensor, _aten.sub.Tensor, _aten.neg.default,
    _aten.view.default, _aten._unsafe_view.default, _aten.reshape.default,
    _aten.t.default, _aten.transpose.int, _aten.permute.default,
    _aten.expand.default, _aten.unsqueeze.default, _aten.squeeze.dim,
    _aten.slice.Tensor, _aten.select.int, _aten.split.Tensor,
    _aten.cat.default, _aten.clone.default, _aten._to_copy.default,
    _aten.alias.default, _aten.detach.default, _aten.copy_.default,
}


def _is_dot(func, args) -> bool:
    """A matrix product with no batch dims: ``mm`` / ``addmm``, or a
    ``bmm`` with an operand broadcast along the batch (stride 0)."""
    if func is _aten.mm.default or func is _aten.addmm.default:
        return True
    return func is _aten.bmm.default and \
        any(a.stride(0) == 0 for a in args[:2])


def _key(t: torch.Tensor):
    """The storage a tensor's values live in (views share it); 0 where
    there is none to follow (meta, empty)."""
    return t.untyped_storage().data_ptr()


def _detached(t: torch.Tensor) -> torch.Tensor:
    # below autograd a plain detach() would not share the version
    # counter; this guard makes it (as torch's selective checkpoint does)
    with torch._C._SetExcludeDispatchKeyGuard(
            torch._C.DispatchKey.ADInplaceOrView, False):
        return t.detach()


def _tensors(items):
    """The tensors among ``items`` and the lists in them (an aten op's
    arguments, or its outputs)."""
    out = []
    for x in items:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


class _Dots:
    """One checkpointed call under ``"dots"``: the products kept by the
    forward (``saved``, in issue order; ``None`` where dropped) and the
    two dispatch modes that fill and read them."""

    def __init__(self):
        self.saved = []            # (tensor, version) or None
        self.deps = {}             # storage -> products its values come from
        self.read = set()          # products some backward reads
        self.done = False

    def wrap(self, fn):
        def run(*args):
            out = fn(*args)
            if not self.done:      # the forward, not the recompute
                self._finish(out)
            return out
        return run

    def contexts(self):
        return _Keep(self), _Reuse(self)

    def _finish(self, out):
        self.done = True
        reached = set()
        for t in _tensors(out if isinstance(out, tuple) else (out,)):
            reached |= self.deps.get(_key(t), set())
        for i in reached - self.read:
            self.saved[i] = None
        self.deps, self.read = {}, set()


class _Mode(TorchDispatchMode):
    @classmethod
    def _should_skip_dynamo(cls):
        # nothing here is compiled: no dynamo guard around each op
        return False


class _Keep(_Mode):
    """The forward: keeps every product with no batch dims and follows
    where its values go."""

    def __init__(self, region: _Dots):
        super().__init__()
        self.region = region

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        r = self.region
        keys_in = {_key(t) for t in _tensors(args)}
        if kwargs:
            keys_in.update(_key(t) for t in _tensors(kwargs.values()))
        keys_in.discard(0)
        deps = set()
        for k in keys_in:
            deps |= r.deps.get(k, set())
        if _is_dot(func, args):
            r.read |= deps         # a product's backward reads its operands
            deps = {len(r.saved)}
            r.saved.append((_detached(out), out._version))
        elif deps and (func not in _LINEAR or not torch.is_grad_enabled()):
            r.read |= deps
        for t in _tensors(out if isinstance(out, (tuple, list)) else (out,)):
            k = _key(t)
            if not k:
                continue
            if k in keys_in:
                if deps:
                    r.deps[k] = r.deps.get(k, set()) | deps
            elif deps:
                r.deps[k] = deps
            else:
                r.deps.pop(k, None)
        return out


class _Reuse(_Mode):
    """The recompute: the kept products in the forward's order, the
    dropped ones computed again."""

    def __init__(self, region: _Dots):
        super().__init__()
        self.region = region
        self.i = 0

    def __enter__(self):
        self.i = 0
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not _is_dot(func, args):
            return func(*args, **kwargs)
        entry = self.region.saved[self.i]
        self.i += 1
        if entry is None:
            return func(*args, **kwargs)
        t, version = entry
        if t._version != version:
            raise RuntimeError(
                "remat_policy 'dots': a kept matrix product was written in "
                "place after the forward")
        return _detached(t)


def checkpoint(fn, *args, policy: str = "nothing"):
    """``fn(*args)`` recomputed in the backward under ``policy`` (one of
    :data:`POLICIES`)."""
    if policy == "nothing":
        return _ckpt.checkpoint(fn, *args, use_reentrant=False)
    if policy == "dots":
        region = _Dots()
        return _ckpt.checkpoint(region.wrap(fn), *args, use_reentrant=False,
                                context_fn=region.contexts)
    raise ValueError(f"remat_policy {policy!r}: one of {POLICIES}")
