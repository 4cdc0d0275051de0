"""Meshes: the card's real one, and the reference's production layouts.

:func:`make_mesh` builds a ``torch.distributed`` ``DeviceMesh`` over the
devices this host has (one H100: ``(1, 1)`` over ``("data", "model")`` on
``cuda:0``; the CPU when asked), setting up a world-of-one process group
first if there is none (its caller, or a test, destroys it with
``torch.distributed.destroy_process_group``).
:func:`make_production_mesh` gives the reference's accounting layouts, 256
and 512 devices, as axis names and sizes with no devices behind them (as
jax's ``AbstractMesh``). Both are functions, never module-level constants:
importing this module touches no device and no process group.
"""
from __future__ import annotations

import dataclasses
import math
import socket


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A mesh's axis names and sizes, with no devices: read as a
    ``DeviceMesh`` is (``mesh_dim_names``, ``shape``, ``size()``)."""
    mesh_dim_names: tuple[str, ...]
    shape: tuple[int, ...]

    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    """16x16 single pod (256 devices) or 2x16x16 two-pod (512 devices)."""
    if multi_pod:
        return MeshLayout(("pod", "data", "model"), (2, 16, 16))
    return MeshLayout(("data", "model"), (16, 16))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over this process
    group's ranks.

    Args:
        shape: devices along each axis; their product is the group's size.
        axes: one name per axis.
        device_type: "cuda" (the card) or "cpu".

    Returns:
        The ``torch.distributed.device_mesh.DeviceMesh``.

    Raises:
        ValueError: the shape does not cover the process group.
    """
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{_free_port()}", world_size=1,
            rank=0)
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {shape} over {dist.get_world_size()} "
                         f"rank(s)")
    return DeviceMesh(device_type,
                      torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=tuple(axes))
