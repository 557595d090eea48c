"""Fault-tolerant checkpoints: atomic, hashed, keep-N, restored anywhere.

The port of the JAX package's ``ckpt/checkpoint.py``, in its file format:
each package reads the other's checkpoints.  Every write goes to a temp
directory, is fsync'd, content-hashed (sha256) and then atomically
renamed, so a crash mid-save never corrupts the newest valid step.
Restore picks the newest step whose hash verifies, so auto-resume after a
failure is a retry loop.  ``restore(step, like, device=)`` puts the
arrays on the given device (the reference's ``shardings``), which is also
the reshard path: save on one mesh, resume on another.

Arrays are stored as one npz shard keyed by the flattened paths of the
saved tree, the reference's keys: a dict's keys in sorted order and a
tuple's or list's indices, joined by ``/`` (``"cell_f"``,
``"atoms/pos"``, ``"0"``).  A JSON manifest carries the step, the keys,
the shard's hash and the caller's ``extra``.  ``last_save`` holds the
seconds of each part of the newest save (the copy to the host, the npz
write, the fsyncs, the hash) and its bytes.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch


def _flat(tree, prefix: str = "", out: Optional[dict] = None) -> dict:
    """``{path: leaf}`` of a tree of dicts, tuples and lists, in the
    reference's order and with its keys."""
    out = {} if out is None else out
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    elif tree is None:
        return out
    else:
        out[prefix] = tree
        return out
    for k, v in items:
        _flat(v, f"{prefix}/{k}" if prefix else k, out)
    return out


def _unflat(like, values: dict, prefix: str = ""):
    """``like``'s structure with each leaf replaced by ``values[path]``."""
    if isinstance(like, dict):
        return {k: _unflat(v, values, f"{prefix}/{k}" if prefix else str(k))
                for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_unflat(v, values,
                                  f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(like))
    if like is None:
        return None
    return values[prefix]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _np_dtype(x) -> np.dtype:
    if isinstance(x, torch.Tensor):
        return torch.empty((), dtype=x.dtype).numpy().dtype
    return np.dtype(x.dtype)


def _hash_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class CheckpointManager:
    """Atomic keep-``keep`` checkpoints under ``directory``; with
    ``async_save`` each write runs on a background thread (the arrays are
    copied to the host before :meth:`save` returns)."""

    def __init__(self, directory: str | Path, keep: int = 3,
                 async_save: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self.last_save: Dict[str, float] = {}

    # ---- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None):
        """Atomic save of a tree of tensors / arrays."""
        t0 = time.perf_counter()
        host = {k: _host(v) for k, v in _flat(tree).items()}
        self.last_save = {"d2h_s": time.perf_counter() - t0,
                          "bytes": sum(v.nbytes for v in host.values())}
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra or {}))
            self._thread.start()
        else:
            self._write(step, host, extra or {})

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: Dict[str, np.ndarray], extra: Dict):
        final = self.dir / f"step_{step:010d}"
        tmp = self.dir / f".tmp_step_{step:010d}_{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        shard = tmp / "shard_0.npz"
        t0 = time.perf_counter()
        np.savez(shard, **host)
        t1 = time.perf_counter()
        with open(shard, "rb") as f:
            os.fsync(f.fileno())
        t2 = time.perf_counter()
        manifest = {
            "step": step,
            "time": time.time(),
            "keys": sorted(host.keys()),
            "hash": {"shard_0.npz": _hash_file(shard)},
            "extra": extra,
        }
        t3 = time.perf_counter()
        mpath = tmp / "manifest.json"
        mpath.write_text(json.dumps(manifest, indent=1))
        with open(mpath, "rb") as f:
            os.fsync(f.fileno())
        self.last_save.update(npz_s=t1 - t0,
                              fsync_s=t2 - t1 + time.perf_counter() - t3,
                              hash_s=t3 - t2)
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic commit
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # ---- restore ------------------------------------------------------------

    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest_valid_step(self) -> Optional[int]:
        for s in reversed(self.all_steps()):
            if self._verify(s):
                return s
        return None

    def _verify(self, step: int) -> bool:
        d = self.dir / f"step_{step:010d}"
        try:
            manifest = json.loads((d / "manifest.json").read_text())
            for fname, want in manifest["hash"].items():
                if _hash_file(d / fname) != want:
                    return False
            return True
        except (OSError, json.JSONDecodeError, KeyError):
            return False

    def restore(self, step: int, like: Any, device=None):
        """Load the arrays of ``step`` in ``like``'s structure.

        ``like``'s leaves (tensors, e.g. on the ``meta`` device, or
        numpy arrays) give each array's shape and dtype; a shape that
        differs raises.  With ``device`` the leaves come back as tensors
        on it, else as numpy arrays.
        """
        d = self.dir / f"step_{step:010d}"
        with np.load(d / "shard_0.npz") as data:
            out = {}
            for key, ref in _flat(like).items():
                arr = data[key]
                if tuple(arr.shape) != tuple(ref.shape):
                    raise ValueError(
                        f"shape mismatch for {key}: ckpt {arr.shape} vs "
                        f"expected {tuple(ref.shape)}")
                arr = arr.astype(_np_dtype(ref))
                if device is not None:
                    arr = torch.as_tensor(np.ascontiguousarray(arr),
                                          device=device)
                out[key] = arr
        return _unflat(like, out)

    def restore_latest(self, like: Any, device=None):
        """Restore the newest step whose hash verifies (a corrupted or
        truncated newer shard is skipped).  Returns ``(step, tree)`` or
        None when no valid checkpoint exists."""
        step = self.latest_valid_step()
        if step is None:
            return None
        return step, self.restore(step, like, device=device)

    def manifest(self, step: int) -> Dict:
        d = self.dir / f"step_{step:010d}"
        return json.loads((d / "manifest.json").read_text())
