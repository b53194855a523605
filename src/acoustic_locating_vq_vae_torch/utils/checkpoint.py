"""Checkpoints and the stage store.

Counterpart of ``acoustic_locating_vq_vae_tpu/utils/checkpoint.py:25-167``,
in the port's own format: a stage is the directory ``stages/<name>/`` holding
one ``torch.save`` file, ``state.pt``, of plain containers and tensors
(state dicts, ints, generator states as uint8 tensors), read back with
``torch.load(weights_only=True)``. ``manifest.json`` has the JAX store's
schema: per stage its ``path``, ``step``, ``time``, the monotonic ``seq``
counter and ``metadata``.

Both the stage file and the manifest are written to a temporary file in the
same directory and moved into place with ``os.replace``, so a process killed
in the middle of a write leaves the previous file whole and never a torn
"newest" checkpoint. A stage is read onto the CPU and copied into its
loader's modules, so a store written on the card loads on the CPU and the
reverse.

The JAX package's stores are orbax directories; reading them needs orbax and
so JAX, which the port does not import. Their weights enter the port through
``eval.params_from_jax`` and ``eval.composite_params_from_jax``.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import warnings
from typing import Any, Optional, Union

import torch

__all__ = ["save_state", "load_state", "StageStore"]

STATE_FILE = "state.pt"


def _replace_atomically(path: str, write) -> None:
    """``write(tmp)`` into a temporary file beside ``path``, then move it
    into place in one step."""
    tmp = os.path.join(os.path.dirname(path), f".{os.path.basename(path)}.tmp")
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_state(path: str, tree: Any) -> None:
    """``torch.save`` of ``tree`` to ``path``, atomically."""
    _replace_atomically(os.path.abspath(path), lambda tmp: torch.save(tree, tmp))


def load_state(path: str, map_location: Union[str, torch.device, None] = "cpu") -> Any:
    """The tree :func:`save_state` wrote, its tensors on ``map_location``."""
    return torch.load(path, map_location=map_location, weights_only=True)


class StageStore:
    """Named checkpoints + manifest, the inter-stage checkpoint API."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        tmp = os.path.abspath(os.environ.get("TMPDIR", "/tmp"))
        if self.root == tmp or self.root.startswith(tmp + os.sep):
            # A machine reboot wiped a whole training run that lived under /tmp.
            warnings.warn(
                f"StageStore root {self.root!r} is under {tmp!r}, which this "
                "machine clears on reboot: a long training run saved here "
                "does not survive a restart. Prefer a durable path (e.g. "
                "<repo>/stores/).",
                stacklevel=2,
            )
        os.makedirs(self.root, exist_ok=True)
        self.manifest_path = os.path.join(self.root, "manifest.json")

    def _manifest(self) -> dict:
        if os.path.exists(self.manifest_path):
            with open(self.manifest_path) as f:
                return json.load(f)
        return {}

    def _write_manifest(self, m: dict) -> None:
        def write(tmp):
            with open(tmp, "w") as f:
                json.dump(m, f, indent=2)

        _replace_atomically(self.manifest_path, write)

    def _stage_path(self, name: str, entry: dict) -> str:
        """Resolve a stage's directory relocatably: this store's own
        ``stages/<name>`` when it exists, else the manifest's recorded path.
        A copied store (``cp -r store new``) carries the original's absolute
        paths in its manifest; resolving against the root first makes the
        copy self-contained instead of reading (or deleting) the original's
        directories."""
        local = os.path.join(self.root, "stages", name)
        if os.path.isdir(local):
            return local
        p = entry.get("path", local)
        return p if os.path.isabs(p) else os.path.join(self.root, p)

    def save_stage(self, name: str, tree: Any, step: int = 0, metadata: Optional[dict] = None) -> str:
        path = os.path.join(self.root, "stages", name)
        os.makedirs(path, exist_ok=True)
        save_state(os.path.join(path, STATE_FILE), tree)
        m = self._manifest()
        m[name] = {
            "path": path,
            "step": int(step),
            "time": time.time(),
            # Monotonic per-store save counter: "which save is newest" must
            # survive wall-clock steps, which time.time() does not. The
            # Trainer's checkpoint GC and restore_latest rank on it.
            "seq": 1 + max((e.get("seq", -1) for e in m.values()), default=-1),
            "metadata": metadata or {},
        }
        self._write_manifest(m)
        return path

    def load_stage(self, name: str) -> Any:
        """The stage's tree, on the CPU (a loader copies it to its device)."""
        m = self._manifest()
        if name not in m:
            raise KeyError(f"stage {name!r} not in {self.manifest_path}; have {list(m)}")
        path = os.path.join(self._stage_path(name, m[name]), STATE_FILE)
        if not os.path.exists(path):
            raise ValueError(
                f"stage {name!r} at {os.path.dirname(path)!r} holds no {STATE_FILE}: it is not a "
                "store of this package (an orbax stage of the JAX package?). Its weights enter "
                "through eval.params_from_jax or eval.composite_params_from_jax."
            )
        return load_state(path)

    def has_stage(self, name: str) -> bool:
        return name in self._manifest()

    def stage_metadata(self, name: str) -> dict:
        """The metadata dict recorded at save time ({} if absent): the task
        configuration that evaluation reads (VQ flatten, input and target
        modes)."""
        return self._manifest().get(name, {}).get("metadata", {}) or {}

    def stages(self) -> dict:
        return self._manifest()

    def delete_stage(self, name: str) -> None:
        """Remove a stage's directory and manifest entry (no-op when absent),
        the primitive behind periodic-checkpoint garbage collection
        (``Trainer(keep_checkpoints=N)``)."""
        m = self._manifest()
        entry = m.pop(name, None)
        if entry is None:
            return
        path = self._stage_path(name, entry)
        # Never delete outside this store: a copied store's manifest can still
        # point at the original's directories; drop the entry, leave those.
        if os.path.isdir(path) and os.path.commonpath([os.path.abspath(path), self.root]) == self.root:
            shutil.rmtree(path, ignore_errors=True)
        self._write_manifest(m)
