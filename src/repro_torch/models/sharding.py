"""Logical→physical sharding rules for params, activations and caches (the
reference's rules, on the port's trees).

Conventions (as the reference's, GSPMD-style):
  * batch-like dims   → ("pod", "data")   (whichever axes the mesh has)
  * model-parallel    → "model": attention heads, FFN hidden, vocab,
                        expert (EP), mamba/mLSTM inner dims
  * everything else   → replicated

A spec is a tuple with one entry a dim: ``None``, an axis name, or a tuple
of axis names, as jax's ``PartitionSpec`` holds them, so a test compares
the two entry for entry. All rules are divisibility-checked against the
mesh in force (:func:`use_mesh`): an axis that does not divide the dim is
dropped. The rules read paths of the reference's stacked layout
(``layers/attn/wq/kernel`` with a leading layer dim), which
``convert.reference_layout`` gives the port's per-layer trees.

Partitioning is ``torch.distributed`` DTensor over a ``DeviceMesh``:
:func:`placements` turns a spec into DTensor placements, :func:`place`
puts a parameter or cache tree on the mesh by the rules (a leaf under k
lists of layers takes its stacked leaf's spec without the first k
entries), and under :func:`partitioned` :func:`shard` redistributes an
activation to its spec, as the reference's ``with_sharding_constraint``
does. With no mesh in force, or on a plain tensor, :func:`shard` returns
its input as it is.
"""
from __future__ import annotations

import contextlib
import contextvars
import re
import weakref
from typing import Any, Iterator, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from ..tree import tree_map_with_path

Spec = tuple

BATCH_AXES = ("pod", "data")
MODEL_AXIS = "model"

# FSDP (ZeRO-3): when enabled, parameter/optimizer leaves additionally
# shard their non-"model" dim over the data axes.
_FSDP = False
_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)


def set_fsdp(enabled: bool) -> None:
    global _FSDP
    _FSDP = bool(enabled)


def axis_sizes(mesh: Any) -> dict[str, int]:
    """Axis name → size of a ``DeviceMesh`` or a ``launch.mesh.MeshLayout``
    (both name their axes ``mesh_dim_names``, sized by ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@contextlib.contextmanager
def use_mesh(mesh: Any) -> Iterator[Any]:
    """The mesh the specs resolve against inside the block (jax's
    ``use_abstract_mesh``/``set_mesh``)."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def mesh_in_force() -> Any:
    """The mesh :func:`use_mesh` put in force, or None."""
    return _MESH.get()


def _mesh_axis_sizes() -> dict[str, int]:
    mesh = _MESH.get()
    return {} if mesh is None else axis_sizes(mesh)


def _resolve(spec_axes: Sequence, shape: Sequence[int],
             sizes: dict[str, int]) -> Spec:
    """Filter logical spec entries by mesh presence + divisibility."""
    out = []
    for dim, entry in zip(shape, spec_axes):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = [a for a in axes if a in sizes]
        factor = 1
        for a in axes:
            factor *= sizes[a]
        if axes and dim % factor == 0:
            out.append(tuple(axes) if len(axes) > 1 else axes[0])
        else:
            out.append(None)
    return tuple(out)


_FLAT = ("pod", "data")
_FLAT_NAME = "pod_data"
_flat_meshes: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def device_mesh(mesh: Any) -> Any:
    """The ``DeviceMesh`` a mesh's DTensors live on: ``mesh`` itself, or,
    where it has both ``pod`` and ``data``, a mesh over the same ranks
    with those two dims flattened pod-major into one, ``pod_data``. Every
    rule names the two together (``BATCH_AXES``), and a dim split over
    ``("pod", "data")`` is a split over that flat dim, as a
    ``PartitionSpec`` splits it; DTensor plans each new redistribution
    over every order of a 3-D mesh's dims, which took it a minute an op
    on a (2, 2, 2) mesh against under a second on the flat (4, 2)."""
    names = tuple(mesh.mesh_dim_names)
    if not set(_FLAT) <= set(names):
        return mesh
    if mesh not in _flat_meshes:
        from torch.distributed.device_mesh import DeviceMesh
        if names[:2] != _FLAT:
            raise ValueError(f"mesh axes {names}: pod and data lead")
        ranks = mesh.mesh.reshape(-1, *mesh.mesh.shape[2:])
        _flat_meshes[mesh] = DeviceMesh(mesh.device_type, ranks,
                                        mesh_dim_names=(_FLAT_NAME,
                                                        *names[2:]))
    return _flat_meshes[mesh]


def placements(spec: Spec, mesh: Any) -> list:
    """The DTensor placements of ``spec`` on ``device_mesh(mesh)``: for
    each of its dims, ``Shard(d)`` where tensor dim d's entry names that
    axis (a leading ``("pod", "data")`` names the flat ``pod_data``), else
    ``Replicate()``.

    Raises:
        ValueError: an axis the mesh lacks, one named twice, or an entry
            that names pod or data alone on a mesh that has both.
    """
    names = list(device_mesh(mesh).mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        key = list(axes)
        if _FLAT_NAME in names and axes[:2] == _FLAT:
            key = [_FLAT_NAME, *axes[2:]]
        where = [names.index(a) if a in names else -1 for a in key]
        if -1 in where or where != sorted(where) or any(
                isinstance(out[i], Shard) for i in where):
            raise ValueError(f"spec {spec} on mesh axes {names}")
        for i in where:
            out[i] = Shard(dim)
    return out


def _spec_at(specs: Any, path: tuple) -> Spec:
    for key in path:
        specs = specs[key]
    return specs


def layer_specs(tree: Any, stacked: Any) -> Any:
    """The spec of each tensor leaf of a port tree, from ``stacked``, the
    specs of its reference layout (``convert.reference_layout``): a leaf
    under k lists of layers takes its stacked leaf's spec without the
    first k entries. Non-tensor leaves (a cache's ``len``) get None.

    A list of layers cannot be split: an axis that a spec puts on a layer
    dim (FSDP's data axes on the blocks of a superblock, where the
    reference's best-effort padding of a rule lands them) is dropped, and
    the port's leaf stays whole along it."""
    def spec_for(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return None
        keys = tuple(k for k in path if not isinstance(k, int))
        return tuple(_spec_at(stacked, keys)[len(path) - len(keys):])
    return tree_map_with_path(spec_for, tree)


def place(tree: Any, specs: Any, mesh: Any) -> Any:
    """Each tensor leaf of ``tree`` as a DTensor on ``mesh`` under its spec
    in ``specs`` (a tree of the same structure, as :func:`layer_specs`
    gives). Every rank holds the whole tensor, so each takes its shard
    where it is, with no communication."""
    def put(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return distribute_tensor(leaf, mesh, _spec_at(specs, path))
    return tree_map_with_path(put, tree)


def distribute_tensor(x: torch.Tensor, mesh: Any, spec: Spec) -> DTensor:
    """``x``, whole on every rank, as a DTensor of ``spec`` on ``mesh``:
    each rank keeps its own slice (no communication)."""
    from torch.distributed.tensor import distribute_tensor as dist_tensor
    return dist_tensor(x, device_mesh(mesh), placements(spec, mesh),
                       src_data_rank=None)


def place_params(params: Any, mesh: Any) -> Any:
    """A port parameter tree on ``mesh`` by the reference's rules
    (:func:`param_specs` over its reference layout)."""
    from .convert import reference_layout
    with use_mesh(mesh):
        specs = param_specs(reference_layout(params))
    return place(params, layer_specs(params, specs), mesh)


def place_cache(cache: Any, mesh: Any) -> Any:
    """A port cache tree on ``mesh`` by the reference's rules
    (:func:`cache_specs` over its reference layout)."""
    from .convert import reference_layout
    with use_mesh(mesh):
        specs = cache_specs(reference_layout(cache))
    return place(cache, layer_specs(cache, specs), mesh)


@contextlib.contextmanager
def partitioned(mesh: Any) -> Iterator[Any]:
    """The block runs partitioned on ``mesh``: the specs resolve against
    it, :func:`shard` constrains, and a plain tensor that the model builds
    in its body (RoPE tables, positions, masks: the same on every rank)
    enters a DTensor op as replicated."""
    with use_mesh(mesh), implicit_replication():
        yield mesh


def _replicate_where(x: torch.Tensor, which) -> torch.Tensor:
    """A DTensor with each placement ``which`` picks made ``Replicate()``
    (the collectives that takes are issued, and counted); a plain tensor,
    or a DTensor with nothing picked, as it is."""
    if not isinstance(x, DTensor):
        return x
    where = [Replicate() if which(p) else p for p in x.placements]
    if where == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, where)


def replicated(x: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole onto every rank, for an op that has no
    sharded strategy, as GSPMD gathers for an op it cannot partition."""
    return _replicate_where(x, lambda p: True)


def settled(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with its partial sums added up (all-reduced), so that the
    next ops read a value, not a pending sum (torch 2.11 loses the mask of
    a vocab-sharded embedding's partial rows once they are reduced, and a
    second reduction fails)."""
    return _replicate_where(x, lambda p: p.is_partial())


def _gathered(x: torch.Tensor, dims) -> torch.Tensor:
    """A DTensor with every mesh dim that shards one of ``dims``
    replicated."""
    return _replicate_where(
        x, lambda p: isinstance(p, Shard) and p.dim in dims)


def unflatten(x: torch.Tensor, dim: int, sizes: tuple) -> torch.Tensor:
    """``x.unflatten(dim, sizes)``. A DTensor whose ``dim`` is sharded over
    more ranks than ``sizes[0]`` divides into (8 kv heads of 128 features
    over a model axis of 16) has that dim gathered first, as GSPMD
    reshards there: DTensor cannot split a sharded dim unevenly. The
    result's gradient is pinned to its placements (see :func:`flatten`)."""
    if not isinstance(x, DTensor):
        return x.unflatten(dim, sizes)
    dim = dim % x.ndim
    ranks = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            ranks *= x.device_mesh.size(i)
    if sizes[0] % ranks:
        x = _gathered(x, (dim,))
    return pinned(x.unflatten(dim, sizes))


def flatten(x: torch.Tensor, start: int, end: int = -1) -> torch.Tensor:
    """``x.flatten(start, end)``. On a DTensor the merged dims after the
    first are gathered where they are sharded first (DTensor in torch 2.11
    cannot view-flatten a dim sharded past the first), and the result's
    gradient is pinned to the placements the merge gave it: a gradient
    that comes back sharded otherwise on the merged dim (4 heads' features
    over a model axis of 16) cannot be split into the heads again."""
    if not isinstance(x, DTensor):
        return x.flatten(start, end)
    start, end = start % x.ndim, end % x.ndim
    return pinned(_gathered(x, range(start + 1, end + 1)).flatten(start,
                                                                   end))


def pinned(y: torch.Tensor) -> torch.Tensor:
    """A DTensor whose gradient comes back on its own placements (see
    :func:`flatten`); a plain tensor as it is."""
    if not isinstance(y, DTensor):
        return y
    return _Constrain.apply(y, tuple(y.placements))


def rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` for a product that folds its leading dims into rows: on a
    DTensor, those dims after the first gathered where they are sharded,
    as sequence parallelism gathers the sequence before a projection
    (DTensor in torch 2.11 cannot fold a dim sharded past the first). The
    product's gradient must come back unfolded alike: pin it
    (:func:`pinned`)."""
    if not isinstance(x, DTensor) or x.ndim <= 2:
        return x
    return _gathered(x, range(1, x.ndim - 1))


def _split_evenly(x: torch.Tensor, n: int) -> torch.Tensor:
    """A DTensor whose dim 0 folds a leading dim of ``n``, with each mesh
    dim that shards dim 0 replicated where, with it, the shards would not
    split ``n`` evenly (DTensor may shard a fold's rows over a mesh dim
    that the leading dim does not divide, 8 rows of 32 tokens over a data
    axis of 16, and then cannot unfold them). The rules drop such an axis
    (``_resolve``); GSPMD reshards there."""
    if not isinstance(x, DTensor):
        return x
    where, ranks = list(x.placements), 1
    for i, p in enumerate(where):
        if isinstance(p, Shard) and p.dim == 0:
            if n % (ranks * x.device_mesh.size(i)):
                where[i] = Replicate()
            else:
                ranks *= x.device_mesh.size(i)
    if where == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, where)


class _FoldedRows(torch.autograd.Function):
    """:func:`_split_evenly` on the value and on its gradient."""

    @staticmethod
    def forward(ctx, x: DTensor, n: int) -> DTensor:
        ctx.n = n
        return _split_evenly(x, n)

    @staticmethod
    def backward(ctx, grad: DTensor):
        return _split_evenly(grad, ctx.n), None


def folded(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x``, a fold whose dim 0 holds a leading dim of ``n``, made
    unfoldable again, and its gradient alike: see :func:`_split_evenly`.
    A plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return _FoldedRows.apply(x, n)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for ``x`` (..., d) and ``w`` (d, f). On a DTensor ``x``
    the leading dims are folded into rows, as ``torch.matmul`` folds them,
    but explicitly: those after the first gathered where sharded
    (:func:`rows`), and the rows kept unfoldable on the way in and out
    (:func:`folded`), so a batch smaller than the data axis traces."""
    if not isinstance(x, DTensor) or x.ndim <= 2:
        return torch.matmul(x, w)
    x = rows(x)
    lead = tuple(x.shape[:-1])
    y = torch.mm(folded(x.reshape(-1, x.shape[-1]), lead[0]), w)
    return folded(y, lead[0]).view(*lead, y.shape[-1])


def whole(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its last dim whole on every rank: gathered where a mesh
    dim splits it, its partial sums added up (all-reduced); its other dims
    stay split where they are. A plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return _replicate_where(x, lambda p: p.is_partial() or (
        isinstance(p, Shard) and p.dim == x.ndim - 1))


def like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x`` placed as ``ref`` is, a tensor of as many dims: a partial sum
    reduce-scattered onto a dim that ``ref`` splits, or all-reduced where
    ``ref`` is whole. A plain ``x`` or ``ref`` leaves ``x`` as it is."""
    if not isinstance(x, DTensor) or not isinstance(ref, DTensor) or \
            list(x.placements) == list(ref.placements):
        return x
    return x.redistribute(x.device_mesh, ref.placements)


def cache_step(fn, cache: torch.Tensor, names: str,
               *args: torch.Tensor, ins: Sequence[str],
               outs: Sequence[str]):
    """``fn(*args)`` for a decode step that advances ``cache``, a cache
    leaf as :func:`cache_specs` placed it, run by each rank on its own
    pieces (:func:`map_shards`) where the leaf lies, so that the advanced
    leaf is formed on the leaf's placements and no state moves.

    ``names`` names the leaf's dims, one letter each (``"bhsd"``);
    ``ins`` and ``outs`` name the dims of each arg and each of ``fn``'s
    results by the same letters (any other letter for a dim the leaf
    lacks). A mesh dim that splits a dim of the leaf splits every arg's
    and result's dim of its letter; an arg without that letter is whole on
    those ranks, and a result without it is a partial sum over them (the
    letter was contracted away). With a plain ``cache``, ``fn(*args)``."""
    if not any(isinstance(a, DTensor) for a in (cache, *args)):
        # no layout to work out: a decode step's host time is mostly its
        # Python, and this is once a layer and step
        return fn(*args)
    groups = tuple(split_axes(cache, d) for d in range(cache.ndim))

    def layout(dims: str, absent) -> tuple:
        return tuple(dims.index(c) if c in dims else (absent if g else None)
                     for c, g in zip(names, groups))

    return map_shards(fn, *args, groups=groups,
                      ins=tuple(layout(t, None) for t in ins),
                      outs=tuple(layout(t, SUM) for t in outs),
                      grads=tuple(layout(t, SUM) for t in ins))


def arange_like(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``torch.arange(x.shape[dim])`` on ``x``'s device, for comparisons
    against ``x`` along ``dim`` (a vocab mask). On a DTensor it is placed
    as that dim of ``x`` is, split where ``x`` splits it and replicated
    elsewhere, so the masks and selects built from it stay split as ``x``
    is, and so do their gradients, where a replicated arange makes them
    whole on every rank."""
    col = torch.arange(x.shape[dim], device=x.device)
    if not isinstance(x, DTensor):
        return col
    from torch.distributed.tensor import distribute_tensor as dist_tensor
    dim = dim % x.ndim
    where = [Shard(0) if isinstance(p, Shard) and p.dim == dim
             else Replicate() for p in x.placements]
    return dist_tensor(col, x.device_mesh, where, src_data_rank=None)


def logsumexp(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``torch.logsumexp(x, dim)``. On a DTensor, as the max (held
    constant, as ``jax.nn.logsumexp`` holds it) plus the log of the sum of
    the exponentials past it: a vocab-sharded dim is then reduced by two
    small all-reduces where DTensor's ``logsumexp`` gathers the dim, as
    GSPMD does not. Both are settled before they are used: torch 2.11
    gives a NaN gradient for ``log`` of a pending sum."""
    if not isinstance(x, DTensor):
        return torch.logsumexp(x, dim=dim)
    top = replicated(x.detach().amax(dim=dim, keepdim=True))
    total = settled(torch.sum(torch.exp(x - top), dim=dim))
    return torch.log(total) + top.squeeze(dim)


def _ranges(rows: int, parts: int, limit: int) -> list:
    """The [start, stop) of each of ``parts`` equal shards of ``rows``
    rows, clipped to the first ``limit``."""
    step = rows // parts
    return [(min(i * step, limit), min((i + 1) * step, limit))
            for i in range(parts)]


def _padded_shard(local: torch.Tensor, rows: int, mesh: Any,
                  mesh_dim: int) -> torch.Tensor:
    """This rank's shard of a table of ``n * local.shape[0]`` rows split
    evenly over mesh dim ``mesh_dim`` of ``n`` ranks, once padded with
    zero rows to ``rows``: the rows it holds stay, and the rows that other
    ranks hold come in one all-to-all of only what moves."""
    n, me = mesh.size(mesh_dim), mesh.get_local_rank(mesh_dim)
    held = local.shape[0] * n
    old, new = _ranges(held, n, held), _ranges(rows, n, held)

    def moved(src: int, dst: int) -> tuple:
        """The rows ``src`` holds that ``dst``'s padded shard takes."""
        lo = max(old[src][0], new[dst][0])
        return lo, max(lo, min(old[src][1], new[dst][1]))

    def mine(dst: int) -> torch.Tensor:
        lo, hi = moved(me, dst)
        return local[lo - old[me][0]:hi - old[me][0]]

    pieces = [local[:0]] * n
    if n > 1:
        sends = [local[:0] if j == me else mine(j) for j in range(n)]
        recv = [0 if j == me else moved(j, me)[1] - moved(j, me)[0]
                for j in range(n)]
        got = _Exchange.apply(torch.cat(sends), recv,
                              [t.shape[0] for t in sends],
                              mesh.get_group(mesh_dim))
        pieces = list(torch.split(got, recv))
    pieces[me] = mine(me)
    width = rows // n - sum(t.shape[0] for t in pieces)
    return torch.cat([*pieces, local.new_zeros(width, *local.shape[1:])])


def _all_to_all(x: torch.Tensor, recv: list, send: list,
                group: Any) -> torch.Tensor:
    from torch.distributed._functional_collectives import (
        all_to_all_single, wait_tensor)
    return wait_tensor(all_to_all_single(x, recv, send, group))


class _Exchange(torch.autograd.Function):
    """One all-to-all of rows among a mesh dim's ranks (``send[j]`` rows
    to rank j, ``recv[j]`` from it); its gradient goes back the other way,
    in one all-to-all of the same rows."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, recv: list, send: list,
                group: Any) -> torch.Tensor:
        ctx.recv, ctx.send, ctx.group = recv, send, group
        return _all_to_all(x, recv, send, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return (_all_to_all(grad.contiguous(), ctx.send, ctx.recv,
                            ctx.group), None, None, None)


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` with zero rows appended up to ``rows``. A DTensor keeps its
    layout: where a mesh dim shards its rows, each rank keeps the rows of
    its padded shard that it holds and receives the rest from the ranks
    that hold them (one all-to-all of the rows that move; GSPMD pads a
    sharded dim with collective permutes), so no rank gathers ``x``; a
    replicated one is padded where it is.

    Raises:
        ValueError: ``x``'s rows sharded over more than one mesh dim, or
            ``rows`` not split evenly over that mesh dim.
    """
    dims = [i for i, p in enumerate(getattr(x, "placements", ()))
            if isinstance(p, Shard) and p.dim == 0]
    if not dims:
        return torch.cat([x, torch.zeros(rows - x.shape[0], *x.shape[1:],
                                         dtype=x.dtype, device=x.device)])
    mesh = x.device_mesh
    if len(dims) > 1 or rows % mesh.size(dims[0]):
        raise ValueError(f"pad_rows: {rows} rows on placements "
                         f"{x.placements} of mesh {mesh.shape}")
    from torch.distributed.tensor.experimental import local_map
    where = list(x.placements)
    return local_map(lambda t: _padded_shard(t, rows, mesh, dims[0]),
                     out_placements=where, in_placements=(where,),
                     device_mesh=mesh)(x)


def per_shard(fn, *tensors: torch.Tensor, dims: tuple = (0, 1)):
    """``fn(*tensors)`` for a computation that is independent along
    ``dims`` (attention over batch and heads): on DTensors, each rank runs
    ``fn`` on its own slices of them, as GSPMD partitions a dot product
    over its batch dims, with every other dim gathered first; plain
    tensors go to ``fn`` as they are. The result has the first tensor's
    placements on ``dims``."""
    return map_shards(fn, *tensors,
                      groups=tuple(split_axes(tensors[0], d) for d in dims),
                      ins=(dims,) * len(tensors), outs=(dims,),
                      grads=(dims,) * len(tensors))


SUM = "sum"


def split_axes(x: torch.Tensor, dim: int) -> tuple:
    """The mesh dims that split dim ``dim`` of ``x``: of ``x.device_mesh``
    for a DTensor, none for a plain tensor."""
    if not isinstance(x, DTensor):
        return ()
    return tuple(i for i, p in enumerate(x.placements)
                 if isinstance(p, Shard) and p.dim == dim % x.ndim)


def rule_axes(shape: Sequence[int], dim: int, *spec_axes) -> tuple:
    """The mesh dims that the rule ``spec_axes`` puts on dim ``dim`` of a
    tensor of ``shape`` under the mesh in force (an axis that does not
    divide its dim dropped, as the rules drop it); none with no mesh."""
    mesh = _MESH.get()
    if mesh is None:
        return ()
    where = placements(_resolve(spec_axes, shape, axis_sizes(mesh)), mesh)
    return tuple(i for i, p in enumerate(where) if p == Shard(dim))


def shard_range(x: torch.Tensor, rows: int, axes: tuple) -> tuple:
    """The [lo, lo + n) of a dim of ``rows`` that this rank holds where
    the mesh dims ``axes`` of ``x.device_mesh`` split it, in mesh order;
    (0, rows) for a plain ``x``."""
    if not isinstance(x, DTensor):
        return 0, rows
    mesh = x.device_mesh
    coord, index, parts = mesh.get_coordinate(), 0, 1
    for i in axes:
        index, parts = index * mesh.size(i) + coord[i], parts * mesh.size(i)
    return index * (rows // parts), rows // parts


def map_shards(fn, *args: Optional[torch.Tensor], groups: tuple,
               ins: tuple, outs: tuple, grads: tuple):
    """``fn`` run by each rank on its own pieces of ``args``, as the
    reference's ``shard_map`` runs a body: for a computation that splits
    along ``groups``, each a tuple of mesh dims (:func:`split_axes`,
    :func:`rule_axes`). A layout gives, for each group in order, the dim
    of the tensor that it splits, :data:`SUM` where the tensor is a
    partial sum over its ranks, or None where they hold it whole; every
    other mesh dim holds it whole.

    Args:
        fn: the body, on local tensors.
        args: DTensors, redistributed to their layouts first where
            they are not in them; plain tensors, whole on every rank,
            each taking its piece where it is; or None, passed as it is.
        groups: the groups of mesh dims.
        ins: the layout of each arg.
        outs: the layout of each of ``fn``'s results (one result, not a
            tuple, where ``outs`` holds one layout).
        grads: the layout of each arg's gradient.

    Returns:
        ``fn``'s results as DTensors of ``outs``; ``fn(*args)`` where no
        arg is a DTensor.

    Raises:
        ValueError: a layout that gives one mesh dim to two groups.
    """
    first = next((a for a in args if isinstance(a, DTensor)), None)
    if first is None:
        return fn(*args)
    from torch.distributed.tensor import distribute_tensor as dist_tensor
    from torch.distributed.tensor.experimental import local_map
    mesh = first.device_mesh

    def where(layout):
        out: list = [Replicate()] * mesh.ndim
        for axes, entry in zip(groups, layout):
            for i in axes if entry is not None else ():
                if not isinstance(out[i], Replicate):
                    raise ValueError(f"map_shards: layout {layout} puts "
                                     f"mesh dim {i} in two groups "
                                     f"{groups}")
                out[i] = Partial() if entry == SUM else Shard(entry)
        return out

    def placed(a, layout):
        if a is None:
            return None
        if not isinstance(a, DTensor):
            return dist_tensor(a, mesh, where(layout), src_data_rank=None)
        if list(a.placements) == where(layout):
            # as it is: a redistribution, even to the same placements,
            # would settle a partial-sum gradient here, before it meets
            # the other gradients of ``a``
            return a
        return a.redistribute(mesh, where(layout))

    def each(layouts):
        return tuple(None if a is None else where(lay)
                     for a, lay in zip(args, layouts))

    args = tuple(placed(a, lay) for a, lay in zip(args, ins))
    out = (where(outs[0]) if len(outs) == 1
           else tuple(where(lay) for lay in outs))
    return local_map(fn, out_placements=out, in_placements=each(ins),
                     in_grad_placements=each(grads),
                     device_mesh=mesh)(*args)


def shard(x: torch.Tensor, *spec_axes) -> torch.Tensor:
    """The reference's activation sharding constraint: under a mesh, a
    DTensor is redistributed to the spec (an axis that does not divide its
    dim dropped, as the rules drop it), and its gradient back to the
    placements it came with; with no mesh in force, or on a plain tensor,
    ``x`` is returned as it is."""
    mesh = _MESH.get()
    if mesh is None or not isinstance(x, DTensor):
        return x
    where = placements(_resolve(spec_axes, x.shape, axis_sizes(mesh)), mesh)
    return _Constrain.apply(x, tuple(where))


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to ``where``; its gradient made contiguous
    and redistributed back to the input's placements, as the transpose of
    the reference's constraint constrains the cotangent. Applied even where
    the input already has ``where``, so the gradient is pinned. Contiguous
    first because DTensor's redistribute of a strided tensor (a transposed
    key's gradient) returns a contiguous local shard under the input's
    global strides, and a later view then fails on the shard."""

    @staticmethod
    def forward(ctx, x: DTensor, where: tuple) -> DTensor:
        # a partial sum's gradient is the same on every rank
        ctx.placements = [Replicate() if p.is_partial() else p
                          for p in x.placements]
        return x.redistribute(x.device_mesh, where)

    @staticmethod
    def backward(ctx, grad: DTensor):
        grad = grad.contiguous()
        return grad.redistribute(grad.device_mesh, ctx.placements), None


def batch_spec(x_shape: Sequence[int]) -> Spec:
    """(batch, ...) arrays: shard dim 0 over pod+data."""
    sizes = _mesh_axis_sizes()
    axes = [BATCH_AXES] + [None] * (len(x_shape) - 1)
    return _resolve(axes, x_shape, sizes) if sizes else ()


# ---------------------------------------------------------------------------
# Parameter rules: path regex → logical spec per dim (matched in order).
# Paths look like "layers/attn/wq/kernel", "layers/moe/wi_gate", ...
# ---------------------------------------------------------------------------

_PARAM_RULES: list[tuple[str, list]] = [
    # embeddings / unembeddings: vocab over model (dropped where the vocab
    # does not divide)
    (r"embed/table$", [MODEL_AXIS, None]),
    (r"lm_head/kernel$", [None, MODEL_AXIS]),
    # attention: out-features of q/k/v over model, in-features of o
    (r"(attn|self_attn|cross_attn|shared_attn)/w[qkv]/kernel$",
     [None, MODEL_AXIS]),
    (r"(attn|self_attn|cross_attn|shared_attn)/w[qkv]/bias$", [MODEL_AXIS]),
    (r"(attn|self_attn|cross_attn|shared_attn)/wo/kernel$",
     [MODEL_AXIS, None]),
    # dense MLPs
    (r"mlp/wi(_gate|_up)?/kernel$", [None, MODEL_AXIS]),
    (r"mlp/wo/kernel$", [MODEL_AXIS, None]),
    (r"mlp/wi/bias$", [MODEL_AXIS]),
    # MoE: expert-parallel over model
    (r"moe/router/kernel$", [None, None]),
    (r"moe/wi_(gate|up)$", [MODEL_AXIS, None, None]),
    (r"moe/wo$", [MODEL_AXIS, None, None]),
    # Mamba2 / mLSTM inner projections
    (r"(mamba|mlstm)/in_proj/kernel$", [None, MODEL_AXIS]),
    (r"(mamba|mlstm)/(out_proj|down)/kernel$", [MODEL_AXIS, None]),
    (r"mlstm/(up|up_gate|wq|wk|wv|w_if)/kernel$", [None, MODEL_AXIS]),
    # everything else replicated
]

_STACKED = re.compile(r"(^|/)(layers|blocks|encoder_layers|superblocks|"
                      r"tail_blocks)(/|$)")


def param_path_str(path: Sequence) -> str:
    return "/".join(str(k) for k in path)


def param_specs(params: Any) -> Any:
    """A spec for each leaf of a parameter tree in the reference's stacked
    layout (the leading layer dim of a stacked leaf is never sharded).

    The reference's, but for one fault of its rules, which the port
    repairs: a rule of two dims on a leaf stacked twice (zamba2's and the
    xLSTM's superblocks) is padded to the wrong arity, and for
    ``mamba/out_proj`` and ``mlstm/down`` that puts ``model`` on the
    blocks of a superblock, not on d_inner as the rule means. There the
    port right-aligns the rule: d_inner over ``model`` wherever that axis
    divides it (and FSDP's data axes on a later free dim)."""
    sizes = _mesh_axis_sizes()

    def spec_for(path, leaf):
        pstr = param_path_str(path)
        ndim = leaf.dim()
        lead = 1 if _STACKED.search(pstr) else 0
        for pattern, axes in _PARAM_RULES:
            if re.search(pattern, pstr):
                body = axes
                if lead + len(body) != ndim:
                    # rule arity mismatch (a leaf stacked twice, as
                    # zamba2's superblocks): the rule's last dims, as the
                    # reference takes them
                    body = axes[-(ndim - lead):] if ndim > lead else []
                full = [None] * lead + list(body)
                layers = max(lead, ndim - len(axes))
                if any(e is not None for e in full[lead:layers]):
                    # ... except where that puts an axis on a layer dim
                    # (out_proj's and down's [model, None]: model over the
                    # blocks of a superblock, which the reference does,
                    # src/repro/models/sharding.py:160-165): the rule is
                    # meant for the leaf's last dims
                    full = [None] * layers + list(axes)
                    lead = layers
                if _FSDP and ndim - lead >= 2:
                    # shard the first free dim over the data axes
                    for i in range(lead, ndim):
                        if full[i] is None:
                            full[i] = BATCH_AXES
                            break
                if not sizes:
                    return ()
                return _resolve(full, leaf.shape, sizes)
        full: list[Optional[Any]] = [None] * ndim
        if _FSDP and ndim - lead >= 2:
            full[lead] = BATCH_AXES
        return () if not sizes else _resolve(full, leaf.shape, sizes)

    return tree_map_with_path(spec_for, params)


# cache leaves stacked twice (superblocks x blocks): zamba2's Mamba-2
# blocks and the xLSTM's mLSTM blocks inside their superblocks
_CACHE_STACKED_TWICE = re.compile(r"^(super|mlstm)/")


def cache_specs(cache: Any) -> Any:
    """KV/state caches in the reference's stacked layout: batch dim over
    pod+data, the first trailing dim the model axis divides over model.

    Leaves are (L, B, H, S, D) KV rings, (L, B, H, s, d) SSM states,
    (L, B, W, C) conv buffers, or lengths. The stacked layer dims are
    never sharded.

    The reference's, but for one fault of its rule, which the port
    repairs: it takes one stacked dim everywhere, so on a leaf stacked
    twice (zamba2's ``super`` and the xLSTM's ``mlstm`` caches, (S, L, B,
    ...)) the batch axes land on the blocks dim, where they are dropped
    unless they divide it, and ``model`` on the batch. There the port
    right-aligns the rule: the batch axes on B, ``model`` on the first
    trailing dim that it divides.
    """
    sizes = _mesh_axis_sizes()
    model_size = sizes.get(MODEL_AXIS, 1)

    def spec_for(path, leaf):
        if not sizes:
            return ()
        ndim = leaf.dim()
        if ndim <= 1:
            return () if ndim == 0 else _resolve([None], leaf.shape, sizes)
        lead = 2 if _CACHE_STACKED_TWICE.search(param_path_str(path)) else 1
        axes: list = [None] * lead + [BATCH_AXES] + [None] * (ndim - lead - 1)
        # heads when the model axis divides them, else sequence (ring
        # decode = sequence-parallel attention), else the state dim
        for d in range(lead + 1, ndim):
            if leaf.shape[d] % model_size == 0 and \
                    leaf.shape[d] >= model_size:
                axes[d] = MODEL_AXIS
                break
        return _resolve(axes, leaf.shape, sizes)

    return tree_map_with_path(spec_for, cache)
