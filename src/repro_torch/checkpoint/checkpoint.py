"""Checkpoints: snapshots of tensor trees, saved on a background thread.

The API is the JAX package's ``checkpoint/checkpoint.py`` (``save_checkpoint``,
``AsyncCheckpointer``, ``latest_checkpoint``, ``restore_checkpoint``, and
garbage collection that keeps the newest ``keep``); the format is the port's
own. One directory per step holds

  * ``tree.json`` -- each leaf's path, shape and dtype,
  * ``data.pt``   -- the leaves as CPU tensors (``torch.save``; bf16 exact),
  * ``meta.json`` -- the step and the caller's metadata (epoch, ...).

A checkpoint is written under ``<dir>.tmp`` and renamed, so a directory
``step_*`` is always complete. Restore refuses a tree of another leaf count
or leaf shape, and puts each leaf on the device and in the dtype of the
tree it restores into.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.tree import leaves, leaves_with_paths, unflatten


def _host(tree: Any) -> list:
    return [t.detach().to("cpu", copy=True) for t in leaves(tree)]


def _write(directory: str, step: int, tree: Any, host: list, meta: Optional[Dict[str, Any]],
           keep: int) -> str:
    path = os.path.join(directory, f"step_{step:010d}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {
        "leaves": [{"path": p, "shape": list(t.shape), "dtype": str(t.dtype)}
                   for (p, _), t in zip(leaves_with_paths(tree), host)],
        "n": len(host),
    }
    with open(os.path.join(tmp, "tree.json"), "w") as f:
        json.dump(manifest, f)
    torch.save(host, os.path.join(tmp, "data.pt"))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, **(meta or {})}, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    _gc(directory, keep)
    return path


def save_checkpoint(
    directory: str,
    step: int,
    tree: Any,
    meta: Optional[Dict[str, Any]] = None,
    keep: int = 3,
) -> str:
    """Synchronous snapshot. Returns the checkpoint path."""
    return _write(directory, step, tree, _host(tree), meta, keep)


def _steps(directory: str) -> list:
    return sorted(d for d in os.listdir(directory) if d.startswith("step_") and not d.endswith(".tmp"))


def _gc(directory: str, keep: int) -> None:
    for d in _steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


class AsyncCheckpointer:
    """Fire-and-forget snapshots on a background thread (one in flight)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None

    def save(self, step: int, tree: Any, meta: Optional[Dict[str, Any]] = None):
        self.wait()
        # copy to the host *before* handing to the thread: the next step
        # updates the device tensors in place
        host = _host(tree)

        def run():
            self.last_path = _write(self.directory, step, tree, host, meta, self.keep)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    ckpts = _steps(directory)
    return os.path.join(directory, ckpts[-1]) if ckpts else None


def restore_checkpoint(path: str, like: Any, device=None) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of ``like``; each leaf takes the dtype of
    ``like``'s leaf and its device, or ``device`` where given (``like`` may
    then lie on the meta device)."""
    with open(os.path.join(path, "tree.json")) as f:
        manifest = json.load(f)
    targets = leaves(like)
    if manifest["n"] != len(targets):
        raise ValueError(f"checkpoint has {manifest['n']} leaves, expected {len(targets)}")
    stored = torch.load(os.path.join(path, "data.pt"), map_location="cpu", weights_only=True)
    arrays = []
    for a, t in zip(stored, targets):
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf shape {tuple(a.shape)} != expected {tuple(t.shape)}")
        arrays.append(a.to(device=device or t.device, dtype=t.dtype))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return unflatten(like, arrays), meta
