"""Dry run: every (arch × shape × mesh) cell of the full configs, without
running the model.

For each cell the step is traced at full width and at the cell's global
shapes on the meta device (no memory, no device work): a train step
(``value_and_grad`` over the ``GRAD_ACCUM`` microbatches, clipping, AdamW's
update), a prefill, or a decode step against a ``seq_len``-deep cache, with
the chunked attention and mixers and remat, as the reference lowers them.

On ``single`` (16 x 16) and ``multi`` (2 x 16 x 16), the reference's
production layouts, the step is partitioned: this process is rank 0 of a
fake process group of 256 or 512 ranks (``launch.mesh.fake_mesh``,
started and destroyed here), the parameters, AdamW's state (placed as the
parameters, as ``zeros_like`` of them), each microbatch and the cache are
DTensors placed by the sharding rules, and the models' ``shard`` calls
constrain the activations. A trace that completes is the port's proof
that the sharding is coherent, as the reference's GSPMD compile is.
:class:`repro_torch.roofline.TraceCounter` reads rank 0's side of it:
the bytes of each collective's result by kind (``coll_bytes_per_dev``,
``coll_breakdown``), the peak of the bytes it holds live, inputs
included (``hbm_per_dev``, the reference's argument + temp + output
bytes), and the FLOPs it runs (``traced_flops``: one rank's, as the
reference's ``xla_raw_flops`` of its SPMD program; compare it with
``flops_per_dev``, the analytic count over the chips). ``card`` is the
(1, 1) layout of one card: its step runs unpartitioned, starts no process
group and moves no collective bytes, and its ``traced_flops`` and
``hbm_per_dev`` are the whole step's. Beside them, the reference's
analytic accounting on the mesh's axis sizes: the parameter count, the
per-device state under the sharding rules, the roofline's FLOPs and bytes
and the model FLOPs. ``trace_seconds`` is the trace's wall time, and
``cache_bytes_by_leaf`` the placed cache's bytes, in all and on rank 0,
by leaf (decode cells).

``--all`` traces the grid one cell a child process, several at a time,
with no device visible (:func:`run_cells`), and prints a summary.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k --mesh card
  python -m repro_torch.launch.dryrun --all --out results/dryrun
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Optional

import torch
from torch.distributed.tensor import DTensor

from ..configs import ARCH_IDS, SHAPES, get_config
from ..configs.base import ModelConfig, ShapeConfig
from ..models import (build_model, cache_specs, count_params, param_specs,
                      reference_layout)
from ..models.convert import META
from ..models.sharding import (axis_sizes, batch_spec, distribute_tensor,
                               mesh_in_force, partitioned, place_cache,
                               place_params, placements, set_fsdp,
                               use_mesh)
from ..optim import AdamW, accumulate_grads, clip_by_global_norm
from ..roofline import Roofline, TraceCounter, cell_bytes, cell_flops
from ..tree import leaves, leaves_with_path
from .mesh import MeshLayout, fake_mesh, make_production_mesh

MESHES = ("single", "multi", "card")
COLL_SOURCES = {
    "partitioned": "traced partitioned step (DTensor, rank 0 of a fake "
                   "process group)",
    "card": "none (one device: the step runs unpartitioned)"}


def sharded_bytes(structs: Any, specs: Any, mesh: Any) -> float:
    """Per-device bytes of a tree of (meta) tensors under ``specs``, its
    leaves summed in the tree's order (as the reference sums them)."""
    sizes = axis_sizes(mesh)
    total = 0.0
    for path, leaf in leaves_with_path(structs):
        spec = specs
        for key in path:
            spec = spec[key]
        shards = 1
        for entry in spec:
            if entry is None:
                continue
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                shards *= sizes.get(ax, 1)
        total += leaf.numel() * leaf.element_size() / shards
    return total


def make_batch_specs(cfg: ModelConfig, shape: ShapeConfig
                     ) -> tuple[dict, dict]:
    """Meta tensors and their specs (under the mesh in force) for one
    input shape."""
    B, S = shape.global_batch, shape.seq_len

    def sh(arr_shape, dtype):
        return torch.empty(arr_shape, dtype=dtype, device=META)

    structs: dict = {}
    if shape.kind in ("train", "prefill"):
        structs["tokens"] = sh((B, S), torch.int32)
        if shape.kind == "train":
            structs["labels"] = sh((B, S), torch.int32)
        if cfg.family == "encdec":
            structs["frames"] = sh((B, cfg.encoder_seq, cfg.d_model),
                                   torch.bfloat16)
        if cfg.family == "vlm":
            structs["vision_embeds"] = sh((B, cfg.vision_tokens,
                                           cfg.d_model), torch.float32)
    else:  # decode: one new token against a seq_len-deep cache
        structs["tokens"] = sh((B, 1), torch.int32)
    return structs, {k: batch_spec(v.shape) for k, v in structs.items()}


# microbatch count per heavy train cell (activation stash / accum)
GRAD_ACCUM: dict[tuple[str, str], int] = {
    ("qwen1.5-110b", "train_4k"): 2,
    ("qwen3-moe-235b-a22b", "train_4k"): 2,
    ("phi3.5-moe-42b-a6.6b", "train_4k"): 2,
    ("minicpm-2b", "train_4k"): 2,
}


def model_flops_for(cfg: ModelConfig, shape: ShapeConfig,
                    n_params: int) -> float:
    n_active = cfg.n_active_params() if cfg.family == "moe" else n_params
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch      # decode: 1 token/row


def trace_step(model, params: Any, batch: dict, shape: ShapeConfig,
               accum: int = 1, cache: Optional[Any] = None,
               mesh: Optional[Any] = None) -> TraceCounter:
    """Trace one step on the tensors' device (the meta device in the dry
    run): train (``accum`` microbatches, clipping, AdamW), prefill, or one
    decode step against ``cache``. With a ``DeviceMesh``, the parameters
    and each microbatch are placed on it by the rules first (the cache
    comes placed: :func:`place_cache`), and the step runs partitioned.

    Returns:
        The :class:`TraceCounter` of the step: collective bytes by kind,
        FLOPs and peak live bytes, of one rank under a mesh.
    """
    micro = [batch]
    if shape.kind == "train":
        size = shape.global_batch // accum
        micro = [{k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                 for i in range(accum)]
    run = contextlib.nullcontext()
    if mesh is not None:
        params = place_params(params, mesh)
        with use_mesh(mesh):
            micro = [{k: distribute_tensor(v, mesh, batch_spec(v.shape))
                      for k, v in mb.items()} for mb in micro]
        run = partitioned(mesh)
    counter = TraceCounter()
    counter.hold((params, micro, cache))
    with run, counter:
        if shape.kind == "train":
            optimizer = AdamW(lr=1e-4)
            state = optimizer.init(params)
            loss, grads = accumulate_grads(model.loss, params, micro)
            grads, _ = clip_by_global_norm(grads, 1.0)
            optimizer.update(grads, state, params)
            outputs = [(loss, ())]
        else:
            with torch.no_grad():
                if shape.kind == "prefill":
                    logits = model.prefill_logits(params, micro[0])
                    outputs = [(logits, batch_spec(logits.shape[:1]))]
                else:
                    logits, new = model.decode_step(
                        params, micro[0]["tokens"], cache)
                    outputs = [(logits, ()), *zip(leaves(new),
                                                   leaves(cache))]
        # the outputs placed as the reference's out_shardings place them
        # (the loss and the decode logits replicated, the prefill logits
        # over the batch axes, the advanced cache as it came in), so the
        # collectives that takes count as GSPMD's do
        for out, where in outputs:
            if isinstance(out, DTensor):
                if isinstance(where, DTensor):
                    where = where.placements
                else:
                    where = placements(tuple(where) + (None,) * (
                        out.ndim - len(where)), mesh_in_force())
                out.redistribute(out.device_mesh, list(where))
    return counter


def account(model, params: Any, shape: ShapeConfig, mesh: Any, *,
            mesh_name: str, cache: Optional[Any] = None,
            counter: Optional[TraceCounter] = None
            ) -> tuple[Roofline, float]:
    """The reference's analytic accounting of one cell on ``mesh``'s axis
    sizes: the roofline, its collective bytes, traced FLOPs and footprint
    taken from ``counter`` (none without one), and the per-device bytes of
    the sharded state (the parameters, with AdamW's m and v for train,
    with ``cache`` for decode).

    Args:
        model: the model of the cell's config.
        params: its parameters, any device (meta in the dry run).
        shape: the cell's shape.
        mesh: a ``DeviceMesh`` or ``MeshLayout``.
        mesh_name: the name the roofline reports.
        cache: the decode cache (decode cells only).
        counter: the trace of the step on one rank of ``mesh``.

    Returns:
        The roofline and the state's bytes a device.
    """
    cfg = model.cfg
    sizes = axis_sizes(mesh)
    chips = mesh.size()
    n_params = count_params(params)
    with use_mesh(mesh):
        p_struct = reference_layout(params)
        param_bytes_dev = sharded_bytes(p_struct, param_specs(p_struct),
                                        mesh)
        cache_bytes_dev = 0.0
        if shape.kind == "train":
            state_bytes_dev = 3 * param_bytes_dev      # + m + v
        elif shape.kind == "decode":
            c_struct = reference_layout(cache)
            cache_bytes_dev = sharded_bytes(c_struct, cache_specs(c_struct),
                                            mesh)
            state_bytes_dev = param_bytes_dev + cache_bytes_dev
        else:
            state_bytes_dev = param_bytes_dev
    coll = dict(counter.collectives) if counter else {}
    roof = Roofline(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        flops_per_dev=cell_flops(cfg, shape)["total_flops"] / chips,
        bytes_per_dev=cell_bytes(cfg, shape,
                                 param_bytes_per_dev=param_bytes_dev,
                                 cache_bytes_per_dev=cache_bytes_dev,
                                 chips=chips,
                                 dp_shards=chips // sizes["model"]),
        coll_bytes_per_dev=float(sum(coll.values())), coll_breakdown=coll,
        model_flops=model_flops_for(cfg, shape, n_params),
        traced_flops=float(counter.flops) if counter else 0.0,
        hbm_per_dev=float(counter.peak_bytes) if counter else None)
    return roof, state_bytes_dev


def leaf_bytes(tree: Any) -> dict:
    """The bytes of a tree's tensor leaves, in all and a device (a
    DTensor's local shard; a plain tensor is whole on its device), summed
    by the leaf's path without its layer indices (``super/state``)."""
    out: dict = {}
    for path, leaf in leaves_with_path(tree):
        if not isinstance(leaf, torch.Tensor):
            continue
        key = "/".join(str(k) for k in path if not isinstance(k, int))
        local = leaf.to_local() if isinstance(leaf, DTensor) else leaf
        whole, dev = out.get(key, (0, 0))
        out[key] = (whole + leaf.numel() * leaf.element_size(),
                    dev + local.numel() * local.element_size())
    return {k: list(v) for k, v in out.items()}


def layout_for(mesh: str) -> MeshLayout:
    """The axis names and sizes of ``mesh``: single, multi or card."""
    if mesh == "card":
        return MeshLayout(("data", "model"), (1, 1))
    return make_production_mesh(multi_pod=mesh == "multi")


def run_cell(arch: str, shape_name: str, mesh: str = "single",
             verbose: bool = True) -> dict:
    """Trace one cell and account for it on ``mesh`` (single, multi or
    card): partitioned on a fake process group of the production mesh,
    which is destroyed before this returns, or unpartitioned on the card.
    Returns the reference's fields, ``compile_seconds`` as
    ``trace_seconds`` and ``xla_raw_flops`` as ``traced_flops``."""
    if mesh not in MESHES:
        raise ValueError(f"mesh {mesh!r}: one of {MESHES}")
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.subquadratic:
        return {"arch": arch, "shape": shape_name, "mesh": mesh,
                "status": "skipped",
                "reason": "full quadratic attention; see DESIGN.md §5"}

    # full configs trace with chunked attention (O(T·c) memory), the
    # chunked SSD/mLSTM mixer (the per-timestep form would keep the
    # matrix memory of every step) and remat
    cfg = dataclasses.replace(cfg, attn_impl="chunked",
                              mixer_impl="chunked", remat=True)
    # FSDP (ZeRO-3) for configs whose f32 params + Adam state exceed
    # 8e9 bytes a device under 16-way model sharding alone: the
    # reference's layout rule, kept so that the specs compare
    set_fsdp(cfg.n_params() * 12 / 16 > 8e9)
    model = build_model(cfg)
    layout = layout_for(mesh)
    t0 = time.perf_counter()
    params = model.init(torch.Generator().manual_seed(0), META)
    batch, _ = make_batch_specs(cfg, shape)
    cache = None
    if shape.kind == "decode":
        cache = model.init_cache(shape.global_batch, shape.seq_len,
                                 device=META)
    accum = GRAD_ACCUM.get((arch, shape_name), 1)
    with (contextlib.nullcontext() if mesh == "card"
          else fake_mesh(layout)) as device_mesh:
        if cache is not None and device_mesh is not None:
            cache = place_cache(cache, device_mesh)
        cache_bytes = leaf_bytes(cache)
        counter = trace_step(model, params, batch, shape, accum, cache,
                             device_mesh)
    trace_s = time.perf_counter() - t0
    roof, state_bytes_dev = account(model, params, shape, layout,
                                    mesh_name=mesh, cache=cache,
                                    counter=counter)
    out = {"status": "ok", "n_params": count_params(params),
           "trace_seconds": round(trace_s, 1),
           "state_bytes_per_dev": state_bytes_dev,
           "cache_bytes_by_leaf": cache_bytes,
           "memory_analysis": {},
           "coll_source": COLL_SOURCES["card" if mesh == "card"
                                       else "partitioned"],
           "coll_by_op": sorted(([kind, op, nbytes] for (kind, op), nbytes
                                 in counter.by_op.items()),
                                key=lambda row: -row[2]),
           **roof.to_dict()}
    if verbose:
        print(f"[{arch} × {shape_name} × {mesh}] "
              f"trace={out['trace_seconds']}s "
              f"t_comp={roof.t_compute*1e3:.1f}ms "
              f"t_mem={roof.t_memory*1e3:.1f}ms "
              f"t_coll={roof.t_collective*1e3:.1f}ms "
              f"bound={roof.bottleneck} "
              f"frac={roof.roofline_frac:.3f} "
              f"state/dev={state_bytes_dev/2**30:.2f}GiB "
              f"hbm/dev={roof.hbm_per_dev/2**30:.2f}GiB "
              f"traced/analytic flops a device="
              f"{roof.traced_flops / roof.flops_per_dev:.3f}")
    return out


# the grid runs each cell in a process of its own (a process holds one
# fake process group), this many at a time: one core left to the parent
JOBS = max(1, (os.cpu_count() or 2) - 1)


def cell_key(arch: str, shape: str, mesh: str) -> str:
    """The name of a cell's files under ``--out``."""
    return f"{arch}__{shape}__{mesh}".replace("/", "_")


def run_cells(cells: list, out: str,
              timeout: Optional[float] = None) -> list[dict]:
    """Each of ``cells`` (arch, shape, mesh) through :func:`run_cell` in a
    child process of its own (``python -m repro_torch.launch.dryrun
    --arch A --shape S --mesh M --out OUT``), with no device visible (the
    trace needs none), :data:`JOBS` at a time in the order given. Each
    child writes its record to ``OUT/<cell>.json`` (a cell whose record is
    there already is not traced again) and its output to
    ``OUT/<cell>.log``.

    Returns:
        The records in the order of ``cells``. A child that fails, or is
        still running ``timeout`` s after the first one started (it is
        then killed), gives ``{"status": "exit N"}`` or ``{"status":
        "timeout"}`` with the path of its ``log``.
    """
    import subprocess
    import sys
    from concurrent.futures import ThreadPoolExecutor

    out = os.path.abspath(out)
    os.makedirs(out, exist_ok=True)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    paths = [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(paths))
    deadline = None if timeout is None else time.perf_counter() + timeout

    def one(cell: tuple) -> dict:
        arch, shape, mesh = cell
        key = cell_key(arch, shape, mesh)
        failed = {"arch": arch, "shape": shape, "mesh": mesh,
                  "log": os.path.join(out, key + ".log")}
        with open(failed["log"], "w") as log:
            try:
                code = subprocess.run(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--shape", shape, "--mesh", mesh,
                     "--out", out], env=env, stdout=log,
                    stderr=subprocess.STDOUT,
                    timeout=None if deadline is None else max(
                        1.0, deadline - time.perf_counter())).returncode
            except subprocess.TimeoutExpired:
                return {**failed, "status": "timeout"}
        path = os.path.join(out, key + ".json")
        if code or not os.path.exists(path):
            return {**failed, "status": f"exit {code}"}
        with open(path) as f:
            return json.load(f)

    with ThreadPoolExecutor(JOBS) as pool:
        return list(pool.map(one, cells))


def main(argv: Optional[list[str]] = None) -> int:
    """One cell in this process, or with ``--all`` every arch x shape on
    the single and multi meshes through :func:`run_cells`, then a summary
    (the torch version, the count of cells by status, the grid's wall
    time, the five slowest cells' ``trace_seconds``), printed and written
    to ``OUT/summary.json``. Returns 1 if a cell of the grid is neither
    ``ok`` nor ``skipped`` (long_500k on quadratic attention), else 0."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=list(MESHES), default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        cells = [(arch, shape, mesh) for arch in ARCH_IDS for shape in SHAPES
                 for mesh in ("single", "multi")]
        t0 = time.perf_counter()
        records = run_cells(cells, args.out)
        status: dict = {}
        for rec in records:
            status[rec["status"]] = status.get(rec["status"], 0) + 1
            if rec["status"] not in ("ok", "skipped"):
                print(f"FAILED {rec['arch']} {rec['shape']} {rec['mesh']}: "
                      f"{rec['status']}, see {rec['log']}", flush=True)
        summary = {"torch": torch.__version__, "cells": len(cells),
                   "status": status, "jobs": JOBS,
                   "wall_seconds": round(time.perf_counter() - t0, 1),
                   "slowest_trace_seconds": sorted(
                       ([rec["trace_seconds"], " ".join(cell)] for cell, rec
                        in zip(cells, records) if rec["status"] == "ok"),
                       reverse=True)[:5]}
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
        print(json.dumps(summary), flush=True)
        return 0 if set(status) <= {"ok", "skipped"} else 1
    if not args.arch or not args.shape:
        ap.error("--arch and --shape required without --all")
    path = os.path.join(args.out,
                        cell_key(args.arch, args.shape, args.mesh) + ".json")
    if os.path.exists(path):
        print(f"[skip existing] {cell_key(args.arch, args.shape, args.mesh)}")
        return 0
    result = run_cell(args.arch, args.shape, args.mesh)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
