"""Meshes: the card's real one, and the reference's production layouts.

:func:`make_mesh` builds a ``torch.distributed`` ``DeviceMesh`` over the
devices this host has (one H100: ``(1, 1)`` over ``("data", "model")`` on
``cuda:0``; the CPU when asked), setting up a world-of-one process group
first if there is none (its caller, or a test, destroys it with
``torch.distributed.destroy_process_group``).
:func:`make_production_mesh` gives the reference's accounting layouts, 256
and 512 devices, as axis names and sizes with no devices behind them (as
jax's ``AbstractMesh``); :func:`fake_mesh` puts such a layout on a fake
process group, this process standing in for rank 0, so that a step can be
traced partitioned on the meta device (as the reference compiles for 512
fake host devices). All are functions, never module-level constants:
importing this module touches no device and no process group.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import socket
from typing import Iterator


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


@contextlib.contextmanager
def fake_mesh(layout: MeshLayout) -> Iterator:
    """A ``DeviceMesh`` of ``layout``'s axis names and sizes on a fake
    process group of ``layout.size()`` ranks, this process rank 0, for
    tracing only: its collectives move no data and return tensors of the
    right shapes. The group is started on entry and destroyed on exit,
    so none outlives the block.

    Raises:
        RuntimeError: a process group is already live in this process
            (one process has one default group).
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(f"fake_mesh {layout.shape}: a "
                           f"{dist.get_backend()} process group is live in "
                           f"this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=layout.size())
    try:
        yield init_device_mesh("cpu", layout.shape,
                               mesh_dim_names=layout.mesh_dim_names)
    finally:
        dist.destroy_process_group()


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
