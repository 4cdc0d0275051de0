#!/usr/bin/env python3
"""Why a co-execution pair's CPU unit runs slower per item than alone.

    PYTHONPATH=src python3 scripts/torch_coexec_cpu_probe.py \
        [--kernels taylor mandelbrot ...] [--repeats 3] \
        [--variants base switch ...]

On a machine with an NVIDIA GPU. For each paper kernel at Table 1 size
(``chip_smoke.py``'s inputs), first the solo speed hints as
``chip_smoke.py`` phase 4 takes them (a package of 1/2 of the rows on
``cuda:0`` and of 1/256 on the CPU, each alone, the second of two), then
the USM hguided pair on [cuda:0, cpu] with phase 4's shares,
``--repeats`` launches (a fresh runtime each, as phase 4 runs one) under
each of ``--variants``, one change each from the port as it is:

- ``base``: the engine as it is;
- ``blocking``: the CUDA unit's completion events made with
  ``blocking=True``, so the worker that waits on one sleeps instead of
  spinning a host core;
- ``threads1``, ``threads4``: torch's intra-op pool at 1 and 4 threads
  beside the CUDA unit (the runtime sets cores - 1);
- ``warm``: two launches on one runtime, the second timed, so the CPU
  unit's worker thread and its kernel are warm;
- ``switch``: the interpreter's thread switch interval at 50 us (the
  default is 5 ms), so a thread that waits for the GIL gets it sooner;
- ``hostfirst``: the CUDA unit launches no package while the CPU unit
  computes one, so the CPU unit's worker meets less Python of the CUDA
  unit's worker for the GIL;
- ``solo+spin``, ``solo+python``: no pair, the CPU unit alone on its solo
  package beside a thread that spins a core outside the GIL (a
  non-blocking CUDA event wait on a long sleep kernel) or beside one
  that runs Python, holding the GIL.

To probe another tree's package, put its ``src`` first on ``PYTHONPATH``.

Each launch prints one JSON line: each unit's busy seconds per item
over its solo hint's (``ratio``; its first package's and the rest's
apart), packages, items and ``total_s``; the CPU unit's packages' sizes
busy seconds and kernel-call seconds (``calls``), the same run again
alone (``alone``, ``alone_calls``) and the pair's busy seconds over
those (``over_alone``); and the share of the CPU unit's
package wall time that its worker thread spent on a core
(``thread_frac``, ``time.thread_time``: the rest it waited). The hints
line also gives each unit's busy time on a one-row package alone
(``fixed_s``), a package's cost that does not scale with its rows, and
the Python-level torch calls one CPU package makes (``cpu_calls``): each
gives up the interpreter lock while it computes and takes it back after
(a plain version run as one TorchScript call makes a handful).
Ends with the card's ``nvidia-smi`` name and power limit.
"""
import argparse
import contextlib
import functools
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", nargs="+",
                    default=["taylor", "gaussian", "matmul", "mandelbrot",
                             "ray", "rap"])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--variants", nargs="+",
                    default=["base", "blocking", "threads1", "threads4",
                             "warm", "switch", "hostfirst", "solo+spin",
                             "solo+python"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_coexec_cpu_probe: no CUDA card", file=sys.stderr)
        return 2
    # after PYTHONPATH, so that another tree's package may be probed
    sys.path.append(os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from torch.overrides import TorchFunctionMode

    from chip_smoke import HINT_FRACS, SEED, table1_inputs
    from repro_torch.api import CoexecSpec, build_kernel
    from repro_torch.core import ArgRole, counits_from_devices
    from repro_torch.core import runtime as runtime_mod
    from repro_torch.core.dataplane import HaloChunk, page_exclusive
    from repro_torch.core.runtime import CoexecutorRuntime
    from repro_torch.core.units import TorchUnit

    # every CPU package's wall and thread seconds; under ``hostfirst`` the
    # CUDA unit's launches wait while one runs
    host = {"busy": 0, "first": False, "spans": []}
    cv = threading.Condition()
    dispatch = TorchUnit.dispatch

    def probed(self, fn, offset, args, out):
        if self.stream is not None:
            if host["first"]:
                with cv:
                    cv.wait_for(lambda: host["busy"] == 0)
            return dispatch(self, fn, offset, args, out)
        with cv:
            host["busy"] += 1
        wall, cpu = time.perf_counter(), time.thread_time()
        try:
            return dispatch(self, fn, offset, args, out)
        finally:
            host["spans"].append((time.perf_counter() - wall,
                                  time.thread_time() - cpu))
            with cv:
                host["busy"] -= 1
                cv.notify_all()

    TorchUnit.dispatch = probed
    rng = np.random.default_rng(SEED)
    inputs = {name: [page_exclusive(a) for a in table1_inputs(name, rng)]
              for name in ("taylor", "gaussian", "matmul", "ray", "rap",
                           "mandelbrot")}

    def launch(name, units, spec, ins, total, warm=False):
        with CoexecutorRuntime.from_spec(spec, units=units) as rt:
            if warm:
                rt.launch(total, build_kernel(name), ins)
            rt.launch(total, build_kernel(name), ins)
            return rt.last_stats, units

    def solo_part(name, device, rows=None):
        rows = rows or max(1, len(inputs[name][0]) // HINT_FRACS[device])
        return rows, [np.ascontiguousarray(a[:rows])
                      if arg.role is ArgRole.SPLIT else a
                      for arg, a in zip(build_kernel(name).args,
                                        inputs[name])]

    only = CoexecSpec.builder().policy("static").memory("usm").build()

    class _Calls(TorchFunctionMode):
        """Counts the Python-level torch calls made in its block."""

        def __init__(self):
            super().__init__()
            self.count = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            self.count += 1
            return func(*args, **(kwargs or {}))

    def cpu_calls(name):
        """The Python-level torch calls one 16-row package of ``name``
        makes on the CPU, its body called as the CPU unit calls it."""
        rows, part = solo_part(name, "cpu", 16)
        kernel = build_kernel(name)
        args = []
        for spec, a in zip(kernel.args, part):
            chunk = torch.from_numpy(np.ascontiguousarray(a))
            if spec.halo:
                chunk = HaloChunk(torch.cat([chunk[:spec.halo], chunk,
                                             chunk[:spec.halo]]), 0, 0)
            args.append(chunk)
        out = torch.from_numpy(kernel.alloc_out(rows, part))
        kernel.fn(0, *args, out=out)        # a TorchScript body compiles
        with _Calls() as calls:
            kernel.fn(0, *args, out=out)
        return calls.count

    def solo_speed(name, device, rows=None):
        rows, part = solo_part(name, device, rows)
        for _ in range(2):
            stats, _ = launch(name, counits_from_devices([device]), only,
                              part, rows)
        return rows / sum(stats.unit_busy_s.values())

    def alone(name, offset, size):
        """Busy and kernel-call seconds of one of a pair's CPU packages
        run again alone (its rows only, a fresh runtime on the CPU)."""
        part = [np.ascontiguousarray(a[offset:offset + size])
                if arg.role is ArgRole.SPLIT else a
                for arg, a in zip(build_kernel(name).args, inputs[name])]
        stats, _ = launch(name, counits_from_devices(["cpu"]), only, part,
                          size)
        return sum(stats.unit_busy_s.values()), host["spans"][-1][0]

    @contextlib.contextmanager
    def variant(kind):
        saved_event, saved_os = torch.cuda.Event, runtime_mod.os
        saved_switch = sys.getswitchinterval()
        threads = {"threads1": 1, "threads4": 4}.get(kind)
        host["first"], host["spans"] = kind == "hostfirst", []
        try:
            if kind == "blocking":
                torch.cuda.Event = functools.partial(saved_event,
                                                     blocking=True)
            if threads:
                class _Os:
                    @staticmethod
                    def cpu_count():
                        return threads + 1
                runtime_mod.os = _Os
            if kind == "switch":
                sys.setswitchinterval(5e-5)
            yield
        finally:
            host["first"] = False
            torch.cuda.Event, runtime_mod.os = saved_event, saved_os
            sys.setswitchinterval(saved_switch)
            torch.set_num_threads(max(1, (os.cpu_count() or 2) - 1))

    def summary(stats, units, speeds, alone=None):
        n = sum(units[p.unit].device.type == "cpu" for p in stats.packages)
        spans = host["spans"][len(host["spans"]) - n:] if n else []
        out = {"total_s": stats.total_s,
               "thread_frac": (sum(c for _, c in spans)
                               / max(sum(w for w, _ in spans), 1e-12))}
        for i, (unit, speed) in enumerate(zip(units, speeds)):
            pk = sorted((p for p in stats.packages if p.unit == i),
                        key=lambda p: p.t_launch)
            key = "cpu" if unit.device.type == "cpu" else "cuda"
            busy = [p.t_complete - p.t_launch for p in pk]
            items = [p.size for p in pk]
            ratio = (lambda b, n: b * speed / n if n else None)
            out[key] = {
                "packages": len(pk), "items": sum(items),
                "busy_s": stats.unit_busy_s[unit.name],
                "ratio": ratio(stats.unit_busy_s[unit.name], sum(items)),
                "first_ratio": ratio(busy[0], items[0]) if pk else None,
                "rest_ratio": ratio(sum(busy[1:]), sum(items[1:]))}
            if key == "cpu" and alone is not None:
                again = [alone(p.offset, p.size) for p in pk]
                out[key].update(
                    sizes=items, busy=busy, calls=[w for w, _ in spans],
                    alone=[b for b, _ in again],
                    alone_calls=[w for _, w in again],
                    over_alone=sum(busy) / max(sum(b for b, _ in again),
                                               1e-12))
        return out

    def background(kind, stop):
        if kind == "spin":
            with torch.cuda.stream(torch.cuda.Stream()):
                while not stop.is_set():
                    torch.cuda._sleep(20_000_000)      # ~10 ms
                    event = torch.cuda.Event()
                    event.record()
                    event.synchronize()
        else:
            x = 0
            while not stop.is_set():
                x += 1

    for name in args.kernels:
        total = len(inputs[name][0])
        gpu, cpu = solo_speed(name, "cuda:0"), solo_speed(name, "cpu")
        share = gpu / (gpu + cpu)
        fixed = {d: 1 / solo_speed(name, d, 1) for d in ("cuda:0", "cpu")}
        print(json.dumps({"kernel": name, "hints": [gpu, cpu],
                          "share": share, "fixed_s": fixed,
                          "cpu_calls": cpu_calls(name),
                          "torch_threads": torch.get_num_threads()}),
              flush=True)
        only_gpu = counits_from_devices(["cuda:0"])
        for rep in range(args.repeats):
            stats, units = launch(name, only_gpu, only, inputs[name], total)
            print(json.dumps({"kernel": name, "variant": "cuda-only",
                              "rep": rep, **summary(stats, units, (gpu,))}),
                  flush=True)
        pair = (CoexecSpec.builder().policy("hguided").memory("usm")
                .pipeline_depth(1).dist(share, 1.0 - share).build())
        for kind in args.variants:
            if kind.startswith("solo+"):
                continue
            for rep in range(args.repeats):
                with variant(kind):
                    units = counits_from_devices(speed_hints=(gpu, cpu))
                    t = time.perf_counter()
                    stats, units = launch(name, units, pair, inputs[name],
                                          total, warm=kind == "warm")
                    wall = time.perf_counter() - t
                    threads = torch.get_num_threads()
                    print(json.dumps({
                        "kernel": name, "variant": kind, "rep": rep,
                        "wall_s": wall, "torch_threads": threads,
                        **summary(stats, units, (gpu, cpu),
                                  functools.partial(alone, name))}),
                        flush=True)
        rows, part = solo_part(name, "cpu")
        for kind in (k[5:] for k in args.variants if k.startswith("solo+")):
            stop = threading.Event()
            thread = threading.Thread(target=background, args=(kind, stop),
                                      daemon=True)
            thread.start()
            try:
                for rep in range(args.repeats):
                    host["spans"] = []
                    stats, units = launch(name, counits_from_devices(["cpu"]),
                                          only, part, rows)
                    print(json.dumps({"kernel": name,
                                      "variant": f"solo+{kind}", "rep": rep,
                                      **summary(stats, units, (cpu,))}),
                          flush=True)
            finally:
                stop.set()
                thread.join()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
