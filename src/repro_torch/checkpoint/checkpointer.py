"""Atomic + async checkpointing (a port of the reference's
``checkpoint/checkpointer.py``, with its on-disk layout, so a checkpoint
written by either package restores in the other).

Layout (one directory per step, atomically renamed into place):

    <dir>/step_00000100/
        manifest.json     leaf keys, dtypes and shapes, user metadata
        arrays.npz        one entry per leaf (key = "/"-joined tree path)

Writes go to ``step_<n>.tmp.<pid>`` and are renamed (atomic on POSIX)
only after the manifest is fsynced: a crash mid-write never corrupts the
latest checkpoint, and ``latest_step`` only sees complete directories.
Leaves are saved whole, on the host; bf16 leaves as their raw 2-byte
words with the manifest dtype ``"bfloat16"``, as the reference stores
them. ``restore`` reads keys and shapes only (the manifest's ``treedef``
is informational) and returns CPU tensors in the template's structure.

``Checkpointer`` adds async saves (a background thread; ``wait()`` joins
it and raises its error), and retention (keep the newest k).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..tree import leaves_with_path, tree_map, unflatten

__all__ = ["Checkpointer", "latest_step", "restore", "save"]

_PREFIX = "step_"
_BF16 = "bfloat16"


def _to_numpy(x) -> Tuple[np.ndarray, str]:
    """A leaf on the host: (array to store, manifest dtype)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(x)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored array as a CPU tensor of the manifest's dtype, in memory
    torch allocated (so it is aligned as every other tensor is)."""
    if dtype == _BF16:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return t.reshape(arr.shape).clone().view(torch.bfloat16)
    if str(arr.dtype) != dtype:
        arr = arr.view(np.dtype(dtype))
    return torch.from_numpy(np.ascontiguousarray(arr)).reshape(
        arr.shape).clone()


def _treedef(tree) -> str:
    return json.dumps([k for k, _ in _keyed(tree)])


def _keyed(tree) -> List[Tuple[str, Any]]:
    return [("/".join(p), leaf) for p, leaf in leaves_with_path(tree)]


def save(directory: str, step: int, tree: Any,
         metadata: Optional[Dict[str, Any]] = None) -> str:
    """Atomically write one checkpoint. Returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"{_PREFIX}{step:08d}")
    tmp = f"{final}.tmp.{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        arrays: Dict[str, np.ndarray] = {}
        manifest_leaves: List[Dict[str, Any]] = []
        for key, leaf in _keyed(tree):
            arr, dtype = _to_numpy(leaf)
            arrays[key] = arr
            manifest_leaves.append(
                {"key": key, "shape": list(arr.shape), "dtype": dtype})
        manifest = {
            "step": step,
            "format": 1,
            "treedef": _treedef(tree),
            "leaves": manifest_leaves,
            "metadata": metadata or {},
            "written_at": time.time(),
        }
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def latest_step(directory: str) -> Optional[int]:
    """Largest complete checkpoint step, or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith(_PREFIX) and ".tmp." not in name:
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                steps.append(int(name[len(_PREFIX):]))
    return max(steps) if steps else None


def restore(directory: str, template: Any, step: Optional[int] = None
            ) -> Tuple[Any, Dict[str, Any]]:
    """Restore a checkpoint into the structure of ``template``.

    ``template``'s leaves may be tensors on any device (``meta`` too) or
    anything with a ``shape``: only its structure, leaf order and shapes
    are used. Shapes are checked against the stored manifest. Returns
    (tree of CPU tensors, metadata)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"{_PREFIX}{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    stored = {l["key"]: l for l in manifest["leaves"]}
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, leaf in _keyed(template):
            if key not in stored:
                raise KeyError(f"checkpoint {path} missing leaf {key!r}")
            arr = data[key]
            want = tuple(getattr(leaf, "shape", arr.shape))
            if tuple(arr.shape) != want:
                raise ValueError(f"leaf {key!r}: stored shape {arr.shape} "
                                 f"!= template {want}")
            out.append(_from_numpy(arr, stored[key]["dtype"]))
    return unflatten(template, out), manifest["metadata"]


class Checkpointer:
    """Async checkpoint manager with retention.

    ``save()`` copies the tree to the host synchronously (the caller may
    then change its tensors in place) and writes on a background thread;
    ``wait()`` joins the outstanding write and raises its error.
    ``keep=k`` retains the newest k checkpoints (older ones are pruned
    after a successful write)."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- public
    def save(self, step: int, tree: Any, metadata: Optional[Dict] = None):
        self.wait()  # one outstanding write at a time
        host_tree = tree_map(_host_copy, tree)
        if not self.async_save:
            save(self.directory, step, host_tree, metadata)
            self._prune()
            return

        def work():
            try:
                save(self.directory, step, host_tree, metadata)
                self._prune()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, template: Any, step: Optional[int] = None):
        self.wait()
        return restore(self.directory, template, step)

    def latest_step(self) -> Optional[int]:
        self.wait()
        return latest_step(self.directory)

    # ------------------------------------------------------------ private
    def _prune(self):
        if not self.keep:
            return
        steps = sorted(
            int(n[len(_PREFIX):])
            for n in os.listdir(self.directory)
            if n.startswith(_PREFIX) and ".tmp." not in n
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(
                os.path.join(self.directory, f"{_PREFIX}{s:08d}"),
                ignore_errors=True,
            )


def _host_copy(x):
    """A snapshot of one leaf on the host that later in-place updates of
    the leaf do not reach."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        return t.clone() if t.device.type == "cpu" else t.cpu()
    return np.array(x)
