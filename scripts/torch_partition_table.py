#!/usr/bin/env python3
"""The partitioned dry run of the port beside the reference's, on the CPU.

    PYTHONPATH=src python3 scripts/torch_partition_table.py

For reduced qwen3-0.6b, phi3.5-moe and zamba2-7b on the (2, 2, 2)
``("pod", "data", "model")`` mesh of the reference's small dry run
(``tests/test_dryrun_small.py``: B 8, T 32), a train step and a decode
step each:

- the port: ``launch.dryrun.run_cell`` partitioned on a fake process group
  of 8 ranks (rank 0's collective bytes by kind, its peak of live bytes,
  its traced FLOPs, the trace's seconds);
- the reference: the step lowered and compiled by GSPMD for 8 forced host
  devices (in a subprocess, so its XLA_FLAGS do not reach this process),
  ``collective_bytes`` of the compiled HLO and ``memory_analysis``'s
  argument + temp + output bytes, as its ``run_cell`` reads them.

Then the production cells ``chip_smoke.py`` phase 11 traces, through the
port only. Prints one JSON object a line; nothing here touches a device.
The two partitioners choose their own collectives: the table records the
difference, it is not a gate.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ["qwen3-0.6b", "phi3.5-moe-42b-a6.6b", "zamba2-7b"]
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

B, T = int(sys.argv[1]), int(sys.argv[2])
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
        p_sh = named(param_specs(ps))
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
        c_sh = named(cache_specs(cache))
        tok = jax.ShapeDtypeStruct((B, 1), jnp.int32)
        decode = jax.jit(lambda p, c, x: model.decode_step(p, x, c),
                         in_shardings=(p_sh, c_sh, NamedSharding(
                             mesh, batch_spec((B, 1)))),
                         out_shardings=(NamedSharding(mesh, P()), c_sh)
                         ).lower(ps, cache, tok).compile()
        rows.append(("decode_32k", decode))
    for shape, compiled in rows:
        coll = collective_bytes(compiled.as_text())
        print("REF " + json.dumps({
            "arch": arch, "shape": shape, "coll_breakdown": coll,
            "coll_bytes_per_dev": sum(coll.values()),
            "hbm_per_dev": footprint(compiled)}), flush=True)
"""


def port_rows():
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
                yield dryrun.run_cell(arch, shape, "multi", verbose=False)
    finally:
        dryrun.get_config, dryrun.SHAPES = full, saved
        dryrun.layout_for = layout


def fields(rec: dict) -> dict:
    return {k: rec[k] for k in (
        "arch", "shape", "mesh", "chips", "coll_breakdown",
        "coll_bytes_per_dev", "hbm_per_dev", "state_bytes_per_dev",
        "traced_flops", "flops_per_dev", "t_collective", "bottleneck",
        "trace_seconds")}


def main() -> None:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    ref = subprocess.run([sys.executable, "-c", REFERENCE, str(B), str(T),
                          *FAMILIES], env=env, capture_output=True,
                         text=True, timeout=1800)
    if ref.returncode:
        sys.exit(ref.stderr[-4000:])
    for line in ref.stdout.splitlines():
        if line.startswith("REF "):
            print(json.dumps({"side": "reference (GSPMD, 8 host devices)",
                              **json.loads(line[4:])}), flush=True)
    for rec in port_rows():
        print(json.dumps({"side": "port (DTensor, rank 0 of 8)",
                          **fields(rec)}), flush=True)
    sys.path.insert(0, ROOT)
    from chip_smoke import PARTITIONED_CELLS
    from repro_torch.launch import dryrun
    for arch, shape, mesh in PARTITIONED_CELLS:
        t = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, mesh, verbose=False)
        print(json.dumps({"side": "port, production mesh",
                          "wall_seconds": round(time.perf_counter() - t, 2),
                          **fields(rec)}), flush=True)


if __name__ == "__main__":
    main()
