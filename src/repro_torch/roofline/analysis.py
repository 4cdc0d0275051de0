"""Three-term roofline of one dry-run cell, on one NVIDIA H100 80GB HBM3
(SXM):

    compute term    = FLOPs_per_device / peak_FLOP/s
    memory term     = HBM_bytes_per_device / HBM_bw
    collective term = collective_bytes_per_device / link_bw

FLOPs and bytes come from the analytic accounting in ``flops.py``.
:func:`collective_bytes` reads the per-device collective bytes of a
partitioned program's HLO text (the reference's parser: result shapes of
every all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute, times the trip counts of the ``xscan[N]`` loops
around them). The port has no HLO: :class:`TraceCounter` reads the same
terms off a traced step on one rank of a DTensor mesh, the bytes of each
collective's result by the same kinds, with the FLOPs that rank runs
(``traced_flops``) and the peak of the bytes it holds live
(``hbm_per_dev``). The port's layer loops are unrolled in the trace, so
no trip count multiplies.

Hardware constants: NVIDIA's H100 datasheet, SXM part, dense rates at the
700 W limit: 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM3, and
NVLink 4 at 900 GB/s per card in both directions together, 450 GB/s each
way.
"""
from __future__ import annotations

import dataclasses
import os
import re
import sys
import weakref
from typing import Any, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

PEAK_FLOPS = 989e12          # bf16 dense, per card
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # bytes/s per card, one direction of NVLink 4

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_COLL_RE = re.compile(
    r"=\s*(\((?:[^()]|\([^()]*\))*\)|[\w\[\],{}]+)\s+"
    r"(" + "|".join(_COLL_KINDS) + r")(-start)?\(")
_DONE_RE = re.compile(r"(" + "|".join(_COLL_KINDS) + r")-done\(")
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_XSCAN_RE = re.compile(r"xscan\[(\d+)\]")
_OPNAME_RE = re.compile(r'op_name="([^"]*)"')


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_bytes(hlo_text: str) -> dict[str, float]:
    """Per-device bytes per collective kind, loop-trip-count corrected.

    Args:
        hlo_text: a compiled SPMD module's text.

    Returns:
        Bytes by collective kind (a ``-start`` counts, its ``-done`` not).
    """
    out: dict[str, float] = {}
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m or _DONE_RE.search(line):
            continue
        mult = 1
        nm = _OPNAME_RE.search(line)
        if nm:
            for c in _XSCAN_RE.findall(nm.group(1)):
                mult *= int(c)
        kind = m.group(2)
        out[kind] = out.get(kind, 0.0) + float(_shape_bytes(m.group(1))
                                               * mult)
    return out


# functional collectives, as DTensor issues them, by the HLO kind the
# reference's parser files them under
_TRACED_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
}
_FUNCOL = ("_c10d_functional", "c10d_functional")
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")
# DTensor's Shard(i) -> Shard(j) redistribution: one all-to-all, which it
# issues as an all-gather and a chunk on a CPU mesh (Gloo has none)
_ALLTOALL = "shard_dim_alltoall"
_OWN = os.sep + "repro_torch" + os.sep
_NOT_OWN = tuple(os.path.join("repro_torch", *p) for p in (
    ("models", "sharding.py"), ("roofline", ""), ("launch", ""),
    ("tree.py",)))
_HELPERS = os.path.join("repro_torch", "models", "sharding.py")
_TRACEBACK_RE = re.compile(r'File "([^"]+)", line \d+, in (\S+)')


def _own_frames(frames) -> list:
    """The two innermost of ``frames`` ((file, function) pairs, innermost
    first) that are the port's own code, outermost first, the sharding
    helpers, the dry run and the counter left out: a collective that a
    helper issues is booked to the function that calls it."""
    names = [name.rsplit("<locals>.", 1)[-1] for path, name in frames
             if _OWN in path and not any(n in path for n in _NOT_OWN)]
    return names[:2][::-1]


def _issuer(dtensor_op: str) -> str:
    """What issues the collective being dispatched: the port's functions
    around it (in a backward pass "grad of" those of the forward op, when
    anomaly mode has recorded its traceback, else the autograd node), then
    the sharding helper they called (the outermost), else an explicit
    redistribute, else ``dtensor_op``, the DTensor op being dispatched."""
    frames, what = [], dtensor_op
    frame = sys._getframe(2)
    while frame is not None:
        code = frame.f_code
        if code.co_filename.endswith(_HELPERS):
            what = code.co_qualname
        elif code.co_name == "redistribute" and \
                code.co_filename.endswith("_api.py") and \
                what == dtensor_op:
            what = "redistribute"
        frames.append((code.co_filename, code.co_qualname))
        frame = frame.f_back
    where = _own_frames(frames)
    node = torch._C._current_autograd_node()
    if node is not None:
        trace = "".join(node.metadata.get("traceback_", []))
        found = _TRACEBACK_RE.findall(trace)[::-1]
        where = ["grad of"] + (_own_frames(found) or [node.name()])
    return " ".join(where + [what])


class TraceCounter(TorchDispatchMode):
    """What one rank runs in a traced step, read op by op: the bytes of
    each collective's result by kind (``collectives``, as
    :func:`collective_bytes` reads an HLO instruction's left-hand shape),
    the FLOPs of its ops (``flops``, by ``FlopCounterMode``'s formulas)
    and the peak of the bytes its live storages hold (``peak_bytes``;
    :meth:`hold` counts the step's inputs first). On a DTensor the mode
    steps aside, so it sees the local ops and collectives DTensor runs
    for this rank; on plain tensors it sees the whole step. Storages are
    counted once however many views share them, and freed when the last
    view dies. Ops that DTensor runs on fake global tensors to derive an
    output's shape are not counted.

    DTensor's Shard -> Shard redistribution (``shard_dim_alltoall``, which
    the counter wraps while it is entered) is one all-to-all: it is booked
    as an all-to-all of the bytes it returns, its result is what stays
    live, and what a CPU mesh runs for it instead (an all-gather of the
    whole dim and a chunk) is neither counted nor held. ``by_op``
    splits the bytes by kind and by what issued them: the model functions
    around the collective (the two innermost, outermost first; "grad of"
    them in a backward pass, named from the forward op's traceback where
    anomaly mode records one, else from the autograd node) and the DTensor
    op it serves (an explicit ``redistribute``, or the aten op).
    """

    def __init__(self) -> None:
        super().__init__()
        self.collectives: dict[str, float] = {}
        self.by_op: dict[tuple[str, str], float] = {}
        self.flops = 0
        self._dtensor_op = "?"
        self._quiet = 0
        self._wrapped: list = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._formulas = FlopCounterMode(display=False).flop_registry
        self._storages: dict[int, weakref.ref] = {}

    def _track(self, tensor: torch.Tensor) -> None:
        storage = tensor.untyped_storage()
        key = id(storage)
        ref = self._storages.get(key)
        if ref is not None and ref() is storage:
            return
        nbytes = storage.nbytes()

        def freed(_, key=key, nbytes=nbytes):
            self.live_bytes -= nbytes
            self._storages.pop(key, None)
        self._storages[key] = weakref.ref(storage, freed)
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def hold(self, tree: Any) -> None:
        """Count the storages of ``tree``'s tensors (a DTensor's local
        shard) as live: the step's parameters, state and inputs."""
        from torch.distributed.tensor import DTensor
        for leaf in tree_leaves(tree):
            if isinstance(leaf, DTensor):
                leaf = leaf.to_local()
            if isinstance(leaf, torch.Tensor):
                self._track(leaf)

    def __enter__(self):
        import torch.distributed.tensor._collective_utils as utils
        original = utils.shard_dim_alltoall

        def alltoall(local, gather_dim, shard_dim, mesh, mesh_dim):
            self._quiet += 1
            try:
                out = original(local, gather_dim, shard_dim, mesh, mesh_dim)
            finally:
                self._quiet -= 1
            self._book("all-to-all", local.numel() * local.element_size())
            self._track(out)
            return out

        # every module that imported it by name (placement_types does)
        for module in list(sys.modules.values()):
            if getattr(module, "__dict__", {}).get(_ALLTOALL) is original:
                setattr(module, _ALLTOALL, alltoall)
                self._wrapped.append((module, original))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            for module, original in self._wrapped:
                setattr(module, _ALLTOALL, original)
            self._wrapped = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            self._dtensor_op = func._overloadpacket.__name__
            return NotImplemented          # DTensor runs, then we see it
        out = func(*args, **(kwargs or {}))
        if self._quiet:
            # inside a Shard -> Shard redistribution: booked as a whole
            return out
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            # DTensor deriving a global shape under FakeTensorMode: no op
            # of this rank's program
            return out
        packet = func._overloadpacket
        if packet in self._formulas:
            self.flops += self._formulas[packet](*args, **(kwargs or {}),
                                                 out_val=out)
        results = [t for t in tree_leaves(out)
                   if isinstance(t, torch.Tensor)]
        if func.namespace in _FUNCOL and \
                packet.__name__ not in _NOT_COLLECTIVES:
            self._book(_TRACED_KINDS.get(packet.__name__, packet.__name__),
                       sum(t.numel() * t.element_size() for t in results))
        for t in results:
            self._track(t)
        return out


    def _book(self, kind: str, nbytes: int) -> None:
        op = _issuer(self._dtensor_op)
        self.collectives[kind] = self.collectives.get(kind, 0.0) + \
            float(nbytes)
        self.by_op[kind, op] = self.by_op.get((kind, op), 0.0) + \
            float(nbytes)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_dev: float          # analytic, loop-aware
    bytes_per_dev: float          # analytic HBM traffic model
    coll_bytes_per_dev: float     # one rank's, from its traced step
    coll_breakdown: dict[str, float]
    model_flops: float            # 6·N·D (train) / 2·N·D (serve), global
    traced_flops: float = 0.0     # one rank's FLOPs in the traced step
    hbm_per_dev: Optional[float] = None   # its traced peak of live bytes

    @property
    def t_compute(self) -> float:
        return self.flops_per_dev / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_dev / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_dev / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / accounted FLOPs — remat/redundancy waste."""
        total = self.flops_per_dev * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_frac(self) -> float:
        """Useful-compute time / bound time ∈ (0, 1]: the score."""
        bound = max(self.t_compute, self.t_memory, self.t_collective)
        t_useful = self.model_flops / self.chips / PEAK_FLOPS
        return t_useful / bound if bound > 0 else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_dev": self.flops_per_dev,
            "bytes_per_dev": self.bytes_per_dev,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "coll_breakdown": self.coll_breakdown,
            "model_flops": self.model_flops,
            "traced_flops": self.traced_flops,
            "hbm_per_dev": self.hbm_per_dev,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_frac": self.useful_flops_frac,
            "roofline_frac": self.roofline_frac,
        }
