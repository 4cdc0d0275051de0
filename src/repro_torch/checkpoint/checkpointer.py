"""Checkpointing: atomic, async, one ``.npz`` per step.

Trees are flattened to path-keyed arrays in a single .npz per checkpoint
(one per step, ``ckpt_<step:010d>.npz`` + a ``latest`` pointer, each
published atomically by rename). A key joins the path's dict keys and list
indices with ``##``, as the reference's ``tree_flatten_with_path`` writes
them, so a checkpoint written by either package restores into the other
(the trainer writes the reference's stacked layout,
:meth:`repro_torch.hetero.HeteroTrainer.state_tree`). ``save_async``
takes the host copy on the caller's thread, then hands it to a writer
thread, so the train loop never blocks on disk and a later in-place
update cannot reach a checkpoint being written. ``restore`` with
``shardings`` places each leaf on the mesh in force as a DTensor, as the
reference's ``device_put`` places it (the format on disk is sharding-free,
so a checkpoint restores onto any mesh).
"""
from __future__ import annotations

import os
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..tree import leaves_with_path, tree_map_with_path

Tree = Any
_SEP = "##"


def _key(path: tuple) -> str:
    return _SEP.join(str(k) for k in path)


def _host(leaf: Any) -> np.ndarray:
    """A numpy copy of a tensor (never a view of it); other leaves as
    numpy arrays, as they are."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _flatten(tree: Tree) -> dict[str, np.ndarray]:
    return {_key(path): _host(leaf) for path, leaf in leaves_with_path(tree)}


def _unflatten_into(template: Tree, flat: dict[str, np.ndarray]) -> Tree:
    """``flat``'s arrays in the template's structure, shapes checked."""
    def fill(path, leaf):
        key = _key(path)
        arr = flat[key]
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else \
            np.shape(leaf)
        if arr.shape != shape:
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {shape}")
        return arr
    return tree_map_with_path(fill, template)


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ----------------------------------------------------------
    def _write(self, step: int, flat: dict[str, np.ndarray]) -> None:
        try:
            path = os.path.join(self.dir, f"ckpt_{step:010d}.npz")
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, **flat)
            os.replace(tmp, path)            # atomic publish
            ptr = os.path.join(self.dir, "latest")
            with open(ptr + ".tmp", "w") as f:
                f.write(str(step))
            os.replace(ptr + ".tmp", ptr)
            self._gc()
        except BaseException as e:           # surfaced on next wait()
            self._error = e

    def _gc(self) -> None:
        ckpts = sorted(p for p in os.listdir(self.dir)
                       if p.startswith("ckpt_") and p.endswith(".npz"))
        for old in ckpts[:-self.keep]:
            os.remove(os.path.join(self.dir, old))

    def save(self, step: int, tree: Tree) -> None:
        self.wait()
        self._write(step, _flatten(tree))

    def save_async(self, step: int, tree: Tree) -> None:
        self.wait()                           # one outstanding save max
        flat = _flatten(tree)                 # host copy happens here
        self._thread = threading.Thread(
            target=self._write, args=(step, flat), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore --------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        ptr = os.path.join(self.dir, "latest")
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            return int(f.read().strip())

    def restore(self, template: Tree, *, step: Optional[int] = None,
                shardings: Optional[Tree] = None) -> tuple[int, Tree]:
        """The checkpoint at ``step`` (the latest by default) in the
        template's structure (its leaves give the keys and the shapes to
        check): numpy arrays, or, with ``shardings``, DTensors on the mesh
        in force.

        Args:
            template: a tree of the checkpoint's structure (arrays or
                tensors; only their shapes are read).
            step: the step to restore.
            shardings: a tree of specs (tuples, as
                ``models.sharding.param_specs`` gives them) in the
                template's structure, resolved against the ``DeviceMesh``
                in force (``models.sharding.use_mesh``). Each leaf is
                placed on that mesh's device type as a DTensor of its
                spec, each rank keeping its own slice.

        Raises:
            FileNotFoundError: no checkpoint in the directory.
            ValueError: a leaf's shape differs from the template's, or
                ``shardings`` was given with no ``DeviceMesh`` in force.
        """
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"ckpt_{step:010d}.npz")
        with np.load(path) as data:
            flat = {k: data[k] for k in data.files}
        tree = _unflatten_into(template, flat)
        if shardings is None:
            return step, tree
        from ..models.sharding import distribute_tensor, mesh_in_force
        mesh = mesh_in_force()
        if not hasattr(mesh, "device_type"):
            raise ValueError("Checkpointer.restore(shardings=...): no "
                             "DeviceMesh in force (models.sharding.use_mesh)")

        def place(path, arr):
            spec = shardings
            for key in path:
                spec = spec[key]
            return distribute_tensor(
                torch.from_numpy(arr).to(mesh.device_type), mesh, spec)
        return step, tree_map_with_path(place, tree)
