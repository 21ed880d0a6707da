"""Fault-tolerant checkpoints in the reference's on-disk format
(``repro.checkpoint.manager``), so either package restores what the
other saved, bit for bit.

* **Format**: a checkpoint directory holds ``arrays.npz`` (one array a
  leaf, keyed by its ``"/"``-joined dict path, :func:`..tree.
  leaves_with_paths`), ``dtypes.json`` (bf16 leaves, stored as a
  ``uint16`` view) and ``manifest.json`` (the step and extras).  bf16 is
  restored through a ``torch.int16`` view; no ``ml_dtypes``.
* **Atomicity**: a checkpoint is written under a temp name and
  ``os.rename``'d into place; the manifest is the commit record, so a
  crash mid-save never corrupts the latest restorable step.
* **Async save**: ``save(..., blocking=False)`` copies the tensors to
  host memory at once, then serializes on a worker thread.
* **Retention**: keeps the newest ``keep`` checkpoints.
* **Mesh-independence (elastic restart)**: a DTensor leaf is saved as
  its unsharded logical value, gathered on every rank (a collective
  each rank of the mesh calls) and written by rank 0 alone; a restore
  given ``shardings`` re-shards every leaf onto the *current* mesh, so a
  run saved on one mesh resumes on another, or on one device.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Optional, Union

import numpy as np
import torch

from .. import devices
from ..models.sharding import distribute, full
from ..tree import leaves_with_paths, map_tree

Device = Union[str, torch.device, None]


def _host(leaf) -> Union[torch.Tensor, np.ndarray]:
    """A leaf as host data owned by the snapshot: a tensor (a DTensor's
    whole value) copied to the CPU (a copy even there, since the train
    step writes in place), or a numpy array."""
    if isinstance(leaf, torch.Tensor):
        return full(leaf.detach()).to("cpu", copy=True)
    return np.array(leaf)


def _writer() -> bool:
    """Whether this process writes: rank 0 of a process group, or the
    only process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _to_numpy(leaf) -> tuple:
    """``(array, dtype name or None)``: bf16 as its ``uint16`` bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":       # an ml_dtypes array
        return arr.view(np.uint16), "bfloat16"
    return arr, None


def save_pytree(tree: dict, directory: str):
    """Serialize one tree of tensors (or arrays) to ``directory``."""
    os.makedirs(directory, exist_ok=True)
    arrays, meta = {}, {}
    for key, leaf in leaves_with_paths(tree):
        arrays[key], kind = _to_numpy(leaf)
        if kind:
            meta[key] = kind
    np.savez(os.path.join(directory, "arrays.npz"), **arrays)
    with open(os.path.join(directory, "dtypes.json"), "w") as f:
        json.dump(meta, f)


def restore_pytree(template: dict, directory: str,
                   device: Device = None, shardings: Optional[dict] = None
                   ) -> dict:
    """Restore into the structure of ``template`` (a tree with any
    leaves: only its keys are read) as tensors on ``device`` (default:
    the card).  ``shardings``: a matching tree of
    :class:`..models.sharding.NamedSharding` (None for a leaf kept whole)
    that places each leaf as a DTensor on the current mesh; every rank
    reads the file and keeps its shards.  Raises ``KeyError`` for a leaf
    the checkpoint lacks."""
    dev = devices.resolve(device)
    with np.load(os.path.join(directory, "arrays.npz")) as z:
        data = {k: z[k] for k in z.files}
    with open(os.path.join(directory, "dtypes.json")) as f:
        meta = json.load(f)
    missing = [k for k, _ in leaves_with_paths(template) if k not in data]
    if missing:
        raise KeyError(f"checkpoint missing leaves: {missing[:5]}...")

    def leaf(key):
        arr = np.asarray(data[key], order="C")   # keeps 0-d arrays 0-d
        if meta.get(key) == "bfloat16":
            return torch.from_numpy(arr.view(np.int16)).view(
                torch.bfloat16).to(dev)
        return torch.from_numpy(arr).to(dev)

    def place(key, sharding):
        t = leaf(key)
        return t if sharding is None else distribute(t, sharding)

    def walk(tree, sh, prefix):
        return {k: walk(v, (sh or {}).get(k), f"{prefix}{k}/")
                if isinstance(v, dict)
                else place(f"{prefix}{k}", (sh or {}).get(k))
                for k, v in tree.items() if v is not None}

    return walk(template, shardings, "")


class CheckpointManager:
    """``step_XXXXXXXX`` checkpoint directories under ``root``."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- discovery -----------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and os.path.exists(
                os.path.join(self.root, name, "manifest.json")
            ):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: dict, blocking: bool = True,
             extra: Optional[dict] = None):
        """Copy ``tree`` to host memory now; serialize it (a)synchronously
        after the previous save has finished.  On a mesh every rank calls
        this (it gathers each DTensor) and rank 0 alone writes."""
        host_tree = map_tree(_host, tree)
        if not _writer():
            return

        def work():
            tmp = tempfile.mkdtemp(dir=self.root, prefix=".tmp_")
            try:
                save_pytree(host_tree, tmp)
                manifest = {"step": step, **(extra or {})}
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                final = self._dir(step)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            self._gc()

        def background():
            try:
                work()
            # tracecheck: allow-broad-except(kept for wait, which re-raises it)
            except BaseException as e:
                self._error = e

        self.wait()
        if blocking:
            work()
        else:
            self._worker = threading.Thread(target=background, daemon=True)
            self._worker.start()

    def wait(self):
        """Join the async save; re-raise what it raised."""
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep] if len(steps) > self.keep else []:
            shutil.rmtree(self._dir(s), ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def restore(self, template: dict, step: Optional[int] = None,
                device: Device = None, shardings: Optional[dict] = None):
        """``(tree, manifest)`` of ``step`` (default: the latest), leaves
        placed by ``shardings`` where given (:func:`restore_pytree`)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        tree = restore_pytree(template, self._dir(step), device, shardings)
        with open(os.path.join(self._dir(step), "manifest.json")) as f:
            manifest = json.load(f)
        return tree, manifest
