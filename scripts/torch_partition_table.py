#!/usr/bin/env python3
"""The partitioned dry run of the port beside the reference's, on the CPU.

    PYTHONPATH=src python3 scripts/torch_partition_table.py

For reduced qwen3-0.6b, phi3.5-moe, zamba2-7b and xlstm-1.3b on the (2, 2, 2)
``("pod", "data", "model")`` mesh of the reference's small dry run
(``tests/test_dryrun_small.py``: B 8, T 32), a train step and a decode
step each:

- the port: ``launch.dryrun.run_cell`` partitioned on a fake process group
  of 8 ranks (rank 0's collective bytes by kind and by the op that issued
  them, its peak of live bytes, its traced FLOPs, the trace's seconds),
  traced under anomaly mode so that a backward collective is booked to
  its forward op;
- the reference: the step lowered and compiled by GSPMD for 8 forced host
  devices (in a subprocess, so its XLA_FLAGS do not reach this process),
  its parameter and cache specs with the two repairs the port makes
  (``tests/_torch_rules.py``: zamba2's out_proj and the xLSTM's down,
  d_inner over model; their twice-stacked ``super`` and ``mlstm``
  caches, the batch over pod and data and model on what follows), so
  both place the same layout,
  ``collective_bytes`` of the compiled HLO and ``memory_analysis``'s
  argument + temp + output bytes, as its ``run_cell`` reads them, and the
  same bytes split by the op that issued each collective: the two
  innermost of the reference's model functions in its stack frames and
  the primitive of its ``op_name`` ("grad of" inside a transpose).

Then, per cell, the port's total and footprint over GSPMD's and both
splits side by side; then the production cells ``chip_smoke.py`` phase 11
traces, through the port only. Prints one JSON object a line; nothing
here touches a device. The two partitioners choose their own collectives:
the table records the difference, it is not a gate.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ["qwen3-0.6b", "phi3.5-moe-42b-a6.6b", "zamba2-7b", "xlstm-1.3b"]
B, T = 8, 32

REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.launch.mesh import make_mesh
from repro.models import build_model, cache_specs, param_specs
from repro.models.sharding import batch_spec
from repro.optim import AdamW, clip_by_global_norm
from repro.roofline import collective_bytes

import re
from repro.roofline.analysis import (_COLL_KINDS, _COLL_RE, _OPNAME_RE,
                                     _XSCAN_RE, _shape_bytes)
_DONE_RE = re.compile("(" + "|".join(_COLL_KINDS) + r")-done\(")

B, T = int(sys.argv[1]), int(sys.argv[2])


def tables(text):
    '''The HLO text's stack-frame tables: frame id -> (function, parent).'''
    def table(name):
        rows, start = {}, text.find("\n" + name + "\n")
        for line in text[start + len(name) + 2:].splitlines():
            key, _, rest = line.partition(" ")
            if start < 0 or not key.isdigit():
                break
            rows[int(key)] = rest
        return rows
    field = lambda row, key: int(row.split(key + "=")[1].split()[0]
                                 .rstrip("}"))
    files, funcs = table("FileNames"), table("FunctionNames")
    locs, frames = table("FileLocations"), table("StackFrames")
    out = {}
    for fid, row in frames.items():
        loc = locs[field(row, "file_location_id")]
        out[fid] = (files[field(loc, "file_name_id")].strip('"'),
                    funcs[field(loc, "function_name_id")].strip('"'),
                    field(row, "parent_frame_id") - 1)
    return out


def by_op(text):
    '''Collective bytes by (kind, op), as ``collective_bytes`` counts
    them: the two innermost model functions around the collective, then
    its primitive.'''
    frames, out = tables(text), {}
    for line in text.splitlines():
        m = _COLL_RE.search(line)
        if not m or _DONE_RE.search(line):
            continue
        name = _OPNAME_RE.search(line)
        name = name.group(1) if name else ""
        mult = 1
        for c in _XSCAN_RE.findall(name):
            mult *= int(c)
        where, fid = [], line.split("stack_frame_id=")
        fid = int(fid[1].split()[0].rstrip("}")) if len(fid) > 1 else 0
        while fid in frames:
            path, func, fid = frames[fid]
            if "/repro/models/" in path and not path.endswith(
                    "sharding.py"):
                where.append(func.rsplit("<locals>.", 1)[-1])
        op = " ".join((["grad of"] if "transpose(" in name else [])
                      + where[:2][::-1]
                      + [name.rsplit("/", 1)[-1] or "no metadata"])
        key = m.group(2) + "|" + op
        out[key] = out.get(key, 0.0) + float(_shape_bytes(m.group(1))
                                             * mult)
    return out
# the reference's specs with the two repairs the port makes
from _torch_rules import intended, intended_cache

mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
named = lambda tree: jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                                  is_leaf=lambda x: isinstance(x, P))


def footprint(compiled):
    ma = compiled.memory_analysis()
    return int(ma.argument_size_in_bytes + ma.temp_size_in_bytes
               + ma.output_size_in_bytes)


for arch in sys.argv[3:]:
    import dataclasses
    cfg = dataclasses.replace(get_config(arch).reduced(), attn_impl="chunked",
                              mixer_impl="chunked", remat=True)
    model = build_model(cfg)
    with jax.sharding.set_mesh(mesh):
        ps = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        p_sh = named(intended(ps, param_specs(ps)))
        batch = {"tokens": jax.ShapeDtypeStruct((B, T), jnp.int32),
                 "labels": jax.ShapeDtypeStruct((B, T), jnp.int32)}
        b_sh = {k: NamedSharding(mesh, batch_spec(v.shape))
                for k, v in batch.items()}
        opt = AdamW(lr=1e-4)
        os_ = jax.eval_shape(opt.init, ps)
        o_sh = type(os_)(step=NamedSharding(mesh, P()), m=p_sh, v=p_sh)

        def train_step(params, opt_state, b):
            (loss, _), g = jax.value_and_grad(model.loss, has_aux=True)(
                params, b)
            g, _ = clip_by_global_norm(g, 1.0)
            params, opt_state = opt.update(g, opt_state, params)
            return params, opt_state, loss

        train = jax.jit(train_step, in_shardings=(p_sh, o_sh, b_sh),
                        out_shardings=(p_sh, o_sh, NamedSharding(mesh, P()))
                        ).lower(ps, os_, batch).compile()
        rows = [("train_4k", train)]
        cache = jax.eval_shape(lambda: model.init_cache(B, T))
        c_sh = named(intended_cache(cache, cache_specs(cache)))
        tok = jax.ShapeDtypeStruct((B, 1), jnp.int32)
        decode = jax.jit(lambda p, c, x: model.decode_step(p, x, c),
                         in_shardings=(p_sh, c_sh, NamedSharding(
                             mesh, batch_spec((B, 1)))),
                         out_shardings=(NamedSharding(mesh, P()), c_sh)
                         ).lower(ps, cache, tok).compile()
        rows.append(("decode_32k", decode))
    for shape, compiled in rows:
        coll = collective_bytes(compiled.as_text())
        text = compiled.as_text()
        print("REF " + json.dumps({
            "arch": arch, "shape": shape, "coll_breakdown": coll,
            "coll_bytes_per_dev": sum(coll.values()),
            "coll_by_op": by_op(text),
            "hbm_per_dev": footprint(compiled)}), flush=True)
"""


def port_rows():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshLayout

    shapes = {"train_4k": ShapeConfig("train_4k", T, B, "train"),
              "decode_32k": ShapeConfig("decode_32k", T, B, "decode")}
    full, layout = dryrun.get_config, dryrun.layout_for
    dryrun.get_config = lambda a: get_config(a).reduced()
    dryrun.SHAPES, saved = shapes, dryrun.SHAPES
    dryrun.layout_for = lambda m: MeshLayout(("pod", "data", "model"),
                                             (2, 2, 2))
    try:
        for arch in FAMILIES:
            for shape in shapes:
                with torch.autograd.set_detect_anomaly(True,
                                                       check_nan=False):
                    yield dryrun.run_cell(arch, shape, "multi",
                                          verbose=False)
    finally:
        dryrun.get_config, dryrun.SHAPES = full, saved
        dryrun.layout_for = layout


def fields(rec: dict) -> dict:
    return {k: rec[k] for k in (
        "arch", "shape", "mesh", "chips", "coll_breakdown",
        "coll_bytes_per_dev", "hbm_per_dev", "state_bytes_per_dev",
        "traced_flops", "flops_per_dev", "t_collective", "bottleneck",
        "trace_seconds")}


def compare(port: dict, ref: dict) -> dict:
    """One cell: the port's total and footprint over GSPMD's, bytes by
    kind side by side ([port, GSPMD]) and by op, largest first."""
    kinds = sorted(set(port["coll_breakdown"]) | set(ref["coll_breakdown"]))
    ops = {}
    for side, split in (("port", port["coll_by_op"]),
                        ("gspmd", ref["coll_by_op"])):
        for key, nbytes in split.items():
            ops.setdefault(key, {"port": 0.0, "gspmd": 0.0})[side] = nbytes
    return {"cell": f"{port['arch']} {port['shape']}",
            "total_ratio": port["coll_bytes_per_dev"]
            / ref["coll_bytes_per_dev"],
            "footprint_ratio": port["hbm_per_dev"] / ref["hbm_per_dev"],
            "by_kind": {k: [port["coll_breakdown"].get(k, 0.0),
                            ref["coll_breakdown"].get(k, 0.0)]
                        for k in kinds},
            "by_op": dict(sorted(ops.items(), key=lambda kv: -max(
                kv[1].values())))}


def main() -> None:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        os.path.join(ROOT, d) for d in ("src", "tests")))
    env.pop("XLA_FLAGS", None)
    ref = subprocess.run([sys.executable, "-c", REFERENCE, str(B), str(T),
                          *FAMILIES], env=env, capture_output=True,
                         text=True, timeout=1800)
    if ref.returncode:
        sys.exit(ref.stderr[-4000:])
    refs = {}
    for line in ref.stdout.splitlines():
        if line.startswith("REF "):
            rec = json.loads(line[4:])
            refs[rec["arch"], rec["shape"]] = rec
            print(json.dumps({"side": "reference (GSPMD, 8 host devices)",
                              **{k: v for k, v in rec.items()
                                 if k != "coll_by_op"}}), flush=True)
    for rec in port_rows():
        rec["coll_by_op"] = {f"{kind}|{op}": nbytes
                             for kind, op, nbytes in rec["coll_by_op"]}
        print(json.dumps({"side": "port (DTensor, rank 0 of 8)",
                          **fields(rec)}), flush=True)
        print(json.dumps({"side": "port / GSPMD",
                          **compare(rec, refs[rec["arch"], rec["shape"]])}),
              flush=True)
    sys.path.insert(0, ROOT)
    from chip_smoke import PARTITIONED_CELLS
    from repro_torch.launch import dryrun
    for arch, shape, mesh in PARTITIONED_CELLS:
        t = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, mesh, verbose=False)
        print(json.dumps({"side": "port, production mesh",
                          "wall_seconds": round(time.perf_counter() - t, 2),
                          **fields(rec),
                          "coll_by_op": rec["coll_by_op"][:8]}), flush=True)


if __name__ == "__main__":
    main()
