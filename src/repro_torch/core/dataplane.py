"""Typed kernel protocol + the real engine's data plane (paper §3.1).

The paper's headline observation is that co-execution gets *cheaper* under
unified shared memory: with USM every Coexecution Unit reads from and
writes into one logical allocation, so result collection is a no-op
(Fig. 2b), whereas per-package Buffers pay an explicit staging copy in and
a copy-back out for every package.

* **`CoexecKernel`** — the typed kernel ABI. A kernel declares its
  per-argument partition semantics: each argument is either ``SPLIT``
  (sliced along a declared axis by the package range, optionally with a
  zero-filled ``halo`` for stencils) or ``BROADCAST`` (every unit sees the
  whole array — MatMul's ``B`` operand), plus an output slot describing
  dtype and trailing shape. The body is ``fn(offset, *chunks, out)``: it
  writes the package's result into ``out`` and returns it. A split
  argument with a halo arrives as a :class:`HaloChunk`: the rows that
  exist plus how many context rows are missing at each end (zeros).
* **Data planes** — one strategy object per
  :class:`~repro_torch.core.memory.MemoryModel`, each meaning on the card
  what it says:

  - :class:`UsmDataPlane` moves nothing. The CPU unit computes on
    ``torch.from_numpy`` views of the launch's arrays; a CUDA unit
    computes on the same host arrays, page-locked and mapped into the
    device's address space once per launch (``cudaHostRegister`` with
    ``cudaHostRegisterMapped``), so its kernels read each package's rows
    and write its result over PCIe in place. ``h2d_copies ==
    d2h_copies == 0`` by construction.
  - :class:`BuffersDataPlane` stages each package: split chunks are
    assembled in reused (pinned, for CUDA) host scratch and copied to the
    unit, broadcast operands are copied per package, and the result is
    copied back into a host buffer before it is merged. Every copy is
    counted in :class:`DataPlaneCounters`, exactly as in the reference.
"""
from __future__ import annotations

import ctypes
import dataclasses
import enum
import logging
import mmap
import threading
import time
import weakref
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .memory import MemoryModel

__all__ = [
    "ArgRole", "ArgSpec", "OutputSpec", "CoexecKernel", "HaloChunk",
    "as_coexec_kernel", "DataPlaneCounters", "LaunchPlan", "Pending",
    "DataPlane", "UsmDataPlane", "BuffersDataPlane", "make_plane",
    "owns_pages", "page_aligned_zeros", "page_exclusive",
]

_log = logging.getLogger(__name__)


class ArgRole(enum.Enum):
    """How the data plane moves one kernel argument (per-argument access)."""

    SPLIT = "split"
    BROADCAST = "broadcast"


@dataclasses.dataclass(frozen=True)
class ArgSpec:
    """Partition semantics of one kernel argument.

    Attributes:
        name: argument name (documentation + error messages).
        role: ``SPLIT`` — sliced to the package range along ``axis``;
            ``BROADCAST`` — the whole array reaches every unit.
        axis: the split axis (``SPLIT`` only).
        halo: extra items on both sides of a split slice, zero-filled
            outside the index space (stencil kernels; ``SPLIT`` only).
        default: zero-arg factory for an argument the caller may omit
            (``BROADCAST`` only).
    """

    name: str
    role: ArgRole = ArgRole.SPLIT
    axis: int = 0
    halo: int = 0
    default: Optional[Callable[[], np.ndarray]] = None

    def __post_init__(self) -> None:
        if self.halo < 0:
            raise ValueError(f"halo must be >= 0, got {self.halo}")
        if self.role is ArgRole.BROADCAST and self.halo:
            raise ValueError(f"arg {self.name!r}: halo is a SPLIT property")
        if self.role is ArgRole.SPLIT and self.default is not None:
            raise ValueError(
                f"arg {self.name!r}: defaults are for BROADCAST args "
                f"(split args define the index space)")


@dataclasses.dataclass(frozen=True)
class OutputSpec:
    """Output slot of a kernel: dtype + trailing shape past the index axis.

    Attributes:
        dtype: numpy dtype of the output container.
        trailing: trailing dims after the split axis — a literal tuple, or
            a callable ``fn(inputs) -> tuple`` for input-dependent shapes
            (MatMul's ``(B.shape[1],)``).
    """

    dtype: Any = np.float32
    trailing: Any = ()

    def trailing_shape(self, inputs: Sequence[np.ndarray]) -> tuple:
        """Resolve the trailing dims for concrete inputs.

        Args:
            inputs: the launch's (bound) input arrays.

        Returns:
            The trailing shape tuple.
        """
        if callable(self.trailing):
            return tuple(self.trailing(inputs))
        return tuple(self.trailing)


class HaloChunk(NamedTuple):
    """A split chunk with a halo: the rows that exist plus missing counts.

    ``lo_pad`` / ``hi_pad`` context rows before / after ``rows`` lie
    outside the index space (or were not copied) and count as zeros; the
    logical chunk has ``package size + 2 * halo`` rows.
    """

    rows: torch.Tensor
    lo_pad: int
    hi_pad: int


@dataclasses.dataclass(frozen=True)
class CoexecKernel:
    """A co-executable kernel: compute body + declared data semantics.

    The body is ``fn(offset, *chunks, out)``: ``offset`` is the package's
    global start, split args arrive as package slices (a
    :class:`HaloChunk` where the arg has a halo), broadcast args arrive
    whole, and the body writes the package's result into ``out`` (a
    tensor on the unit's device) and returns it.

    ``rowwise`` declares that the body ignores ``offset`` and computes
    each row of its output from the same row of its chunks alone. A fused
    batch (which only all-split kernels join) then runs a member-stacked
    ``(members, bucket, ...)`` chunk as one ``(members * bucket, ...)``
    chunk, one body call per package; any other kernel runs once per
    member at offset 0.

    Instances are hashable (units memoize their warm-up on them).
    """

    name: str
    fn: Callable
    args: tuple[ArgSpec, ...]
    out: OutputSpec = OutputSpec()
    rowwise: bool = False

    @property
    def all_split(self) -> bool:
        """True when every arg is a plain axis-0 split with no halo."""
        return all(a.role is ArgRole.SPLIT and a.axis == 0 and a.halo == 0
                   for a in self.args)

    def bind(self, inputs: Sequence[np.ndarray]) -> list:
        """Fill omitted trailing defaults and return the full input list.

        Args:
            inputs: caller-supplied arrays, shortest-prefix order.

        Returns:
            One array per declared argument.

        Raises:
            ValueError: wrong argument count (missing args without a
                default, or extras).
        """
        bound = list(inputs)
        for spec in self.args[len(bound):]:
            if spec.default is None:
                raise ValueError(
                    f"kernel {self.name!r} takes {len(self.args)} args "
                    f"({', '.join(a.name for a in self.args)}); "
                    f"got {len(inputs)}")
            bound.append(np.asarray(spec.default()))
        if len(bound) > len(self.args):
            raise ValueError(
                f"kernel {self.name!r} takes {len(self.args)} args "
                f"({', '.join(a.name for a in self.args)}); "
                f"got {len(inputs)}")
        return bound

    def alloc_out(self, total: int,
                  inputs: Sequence[np.ndarray]) -> np.ndarray:
        """Allocate the host output container for a launch.

        Args:
            total: launch index-space size.
            inputs: the launch's input arrays (for input-dependent
                trailing shapes).

        Returns:
            A zeroed ``(total, *trailing)`` array of the declared dtype
            that owns its pages, so USM maps it in place.
        """
        trailing = self.out.trailing_shape(self.bind(inputs))
        return page_aligned_zeros((total, *trailing), self.out.dtype)


def as_coexec_kernel(fn: Callable, num_args: int) -> CoexecKernel:
    """Wrap a positional package closure in the typed protocol.

    The compatibility adapter for closures ``fn(offset, *chunks) -> chunk``
    that return their result instead of writing it: every argument is a
    plain axis-0 split and the returned chunk is written into ``out``.

    Args:
        fn: legacy package kernel.
        num_args: how many input arrays the kernel takes.

    Returns:
        An equivalent :class:`CoexecKernel` with all-``SPLIT`` args.
    """
    if isinstance(fn, CoexecKernel):
        return fn
    args = tuple(ArgSpec(f"arg{i}") for i in range(num_args))
    return CoexecKernel(getattr(fn, "__name__", "kernel"),
                        _ReturningBody(fn), args)


@dataclasses.dataclass(frozen=True)
class _ReturningBody:
    """Body of an adapted closure: its returned chunk is written to ``out``.

    Equal for the same closure, so two launches of one closure get equal
    kernels (and may fuse), as in the reference.
    """

    fn: Callable

    def __call__(self, offset, *chunks, out):
        return out.copy_(self.fn(offset, *chunks))


# ---------------------------------------------------------------------------
# Instrumentation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DataPlaneCounters:
    """Copy/dispatch accounting of one launch (or one simulated run).

    Attributes:
        dispatches: package executions issued to the units.
        h2d_copies: explicit host→unit staging copies (a package slice or
            broadcast operand). Zero under USM.
        h2d_bytes: bytes moved by those staging copies.
        d2h_copies: explicit unit→host copy-backs through a per-package
            buffer before the merge. Zero under USM (results land in the
            shared container directly).
        d2h_bytes: bytes moved by those copy-backs.
    """

    dispatches: int = 0
    h2d_copies: int = 0
    h2d_bytes: int = 0
    d2h_copies: int = 0
    d2h_bytes: int = 0

    @property
    def staging_copies(self) -> int:
        """Total explicit staging copies (H2D + D2H) this launch paid."""
        return self.h2d_copies + self.d2h_copies

    def snapshot(self) -> "DataPlaneCounters":
        """An independent copy (for freezing into launch stats)."""
        return dataclasses.replace(self)

    def split(self, n: int) -> list["DataPlaneCounters"]:
        """Divide these counters into ``n`` shares that sum to the whole.

        Args:
            n: number of shares (the fused member count).

        Returns:
            ``n`` counter objects whose fields sum to this object's; the
            division remainder lands on the first shares.
        """
        shares = [DataPlaneCounters() for _ in range(n)]
        for field in dataclasses.fields(self):
            total = getattr(self, field.name)
            base, rem = divmod(int(total), n)
            for i, share in enumerate(shares):
                setattr(share, field.name, base + (1 if i < rem else 0))
        return shares

    def to_dict(self) -> dict:
        """Plain-dict form for JSON artifacts."""
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Mapped host memory (USM on a CUDA unit)
# ---------------------------------------------------------------------------
# Page-locking is process-wide CUDA state kept per page: a page may sit in
# one registration only, and two arrays (or two launches' arrays) can share
# pages. The registry below holds disjoint page-aligned ranges, each
# counted by the arrays that touch it; an array maps the pages no range
# covers yet and shares the rest. With unified addressing a mapped range's
# device address is its host address, so an array spanning several ranges
# stays one contiguous device view.
#
# CUDA takes a host pointer inside a registered page for page-locked
# memory, so a pageable copy of an array that shares a page with a mapped
# one fails (``cudaErrorInvalidValue``). Only arrays that own their pages
# are therefore mapped in place; any other is mapped through a page-aligned
# copy (:func:`owns_pages`, :func:`page_exclusive`).
_PAGE = mmap.PAGESIZE
_mapped_lock = threading.Lock()
_mapped: dict[int, list] = {}   # start -> [end, users]; guarded-by: _mapped_lock


def page_aligned_zeros(shape, dtype) -> np.ndarray:
    """A zeroed C-contiguous array that owns whole pages.

    It starts on a page and its allocation runs to the end of its last
    page, so no other allocation shares a page with it and USM maps it in
    place (:func:`owns_pages`).

    Args:
        shape: the array's shape.
        dtype: its dtype.

    Returns:
        A view into a private page-padded byte buffer.
    """
    dtype = np.dtype(dtype)
    shape = tuple(int(d) for d in np.atleast_1d(shape))
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    buf = np.zeros(-(-nbytes // _PAGE) * _PAGE + _PAGE, np.uint8)
    start = -buf.ctypes.data % _PAGE
    return buf[start:start + nbytes].view(dtype).reshape(shape)


def owns_pages(arr: np.ndarray) -> bool:
    """Whether every page under ``arr`` lies inside its own allocation.

    True when the array starts and ends on page boundaries, or when the
    numpy array that owns its memory spans the pages it touches (as
    :func:`page_aligned_zeros` arranges). Another view of that same
    allocation may still share the pages: do not copy such a view
    between host and card while the array is mapped.
    """
    ptr = arr.ctypes.data
    lo = ptr - ptr % _PAGE
    hi = -(-(ptr + arr.nbytes) // _PAGE) * _PAGE
    if arr.nbytes == 0 or (lo == ptr and hi == ptr + arr.nbytes):
        return True
    root = arr
    while isinstance(root.base, np.ndarray):
        root = root.base
    if root.base is not None:           # memory owned outside numpy
        return False
    start = root.ctypes.data
    return start <= lo and hi <= start + root.nbytes


def page_exclusive(arr: np.ndarray) -> np.ndarray:
    """``arr`` if it owns its pages, else a page-aligned copy of it."""
    arr = np.ascontiguousarray(arr)
    if owns_pages(arr):
        return arr
    copy = page_aligned_zeros(arr.shape, arr.dtype)
    np.copyto(copy, arr)
    return copy


def _split_pages(lo: int, hi: int, ranges) -> tuple[list, list]:
    """Split the page range [lo, hi) against registered ``ranges``.

    Args:
        lo: page-aligned start.
        hi: page-aligned end.
        ranges: disjoint registered ``(start, end)`` pairs.

    Returns:
        ``(hits, gaps)``: the registered ranges overlapping [lo, hi), and
        the page ranges inside [lo, hi) that none covers, both in order.
    """
    hits = sorted((s, e) for s, e in ranges if s < hi and lo < e)
    gaps, cursor = [], lo
    for s, e in hits:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if cursor < hi:
        gaps.append((cursor, hi))
    return hits, gaps


class _CudaArray:
    """``__cuda_array_interface__`` over a mapped host range."""

    def __init__(self, dev_ptr: int, arr: np.ndarray):
        self.__cuda_array_interface__ = {
            "shape": arr.shape, "typestr": arr.dtype.str,
            "data": (dev_ptr, False), "version": 2, "strides": None}


def _map_host(arr: np.ndarray, device: torch.device
              ) -> tuple[torch.Tensor, list]:
    """A tensor on ``device`` aliasing ``arr``'s page-locked host memory.

    Returns:
        ``(view, starts)``: the device view and the registered ranges it
        holds, for :func:`_unmap_host`.

    Raises:
        ValueError: a non-contiguous array (it is mapped, never copied).
        RuntimeError: CUDA refused to page-lock or map it.
    """
    from ..kernels import _lib

    if not arr.flags.c_contiguous:
        raise ValueError("USM on a CUDA unit needs C-contiguous arrays "
                         "(they are mapped in place, never copied)")
    if arr.nbytes == 0:
        return torch.empty(arr.shape, dtype=_torch_dtype(arr.dtype),
                           device=device), []
    lib = _lib.library()
    ptr = arr.ctypes.data
    lo = ptr - ptr % _PAGE
    hi = -(-(ptr + arr.nbytes) // _PAGE) * _PAGE
    with _mapped_lock:
        hits, gaps = _split_pages(lo, hi, [(s, v[0])
                                           for s, v in _mapped.items()])
        done = []
        try:
            for s, e in gaps:
                _lib.check(lib.host_register_mapped(s, e - s),
                           "cudaHostRegister (mapped)")
                done.append(s)
            dev_ptr = ctypes.c_void_p()
            _lib.check(lib.host_device_pointer(ptr, ctypes.byref(dev_ptr)),
                       "cudaHostGetDevicePointer")
        except BaseException:
            for s in done:
                lib.host_unregister(s)
            raise
        for s, e in gaps:
            _mapped[s] = [e, 0]
        starts = [s for s, _ in hits + gaps]
        for s in starts:
            _mapped[s][1] += 1
    return torch.as_tensor(_CudaArray(dev_ptr.value, arr),
                           device=device), starts


def _unmap_host(starts: list) -> None:
    """Drop one array's hold on its ranges; unregister the unused ones."""
    from ..kernels import _lib

    with _mapped_lock:
        for s in starts:
            entry = _mapped[s]
            entry[1] -= 1
            if entry[1] == 0:
                del _mapped[s]
                _lib.check(_lib.library().host_unregister(s),
                           "cudaHostUnregister")


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


class LaunchPlan:
    """Per-launch data-plane state: bound kernel, arrays, counters.

    Built once per submit by :meth:`DataPlane.plan`; worker threads share
    it (counter updates are lock-protected, the arrays are only read and
    the output container is written in disjoint package ranges). Under
    USM it also holds the per-device views of the arrays and the mapped
    host ranges, which :meth:`release` gives back once the launch ends,
    and ``out_stage``: the page-aligned copy a CUDA unit writes when
    ``out`` shares a page with another allocation (``None`` otherwise).
    """

    __slots__ = ("kernel", "inputs", "out", "total", "counters", "trailing",
                 "out_stage", "_views", "_mapped_starts", "_held", "_lock")

    def __init__(self, kernel: CoexecKernel, inputs: list, out: np.ndarray,
                 total: int):
        self.kernel = kernel
        self.inputs = inputs
        self.out = out
        self.total = int(total)
        self.counters = DataPlaneCounters()
        self.trailing = tuple(out.shape[1:])
        self.out_stage: Optional[np.ndarray] = None
        self._views: dict[str, tuple] = {}  # guarded-by: _lock
        self._mapped_starts: list = []      # guarded-by: _lock
        self._held: list = []               # guarded-by: _lock
        self._lock = threading.Lock()

    def add(self, **deltas: int) -> None:
        """Atomically bump counter fields by the given deltas."""
        with self._lock:
            for key, delta in deltas.items():
                setattr(self.counters, key, getattr(self.counters, key)
                        + int(delta))

    def views(self, device: torch.device) -> tuple[list, torch.Tensor]:
        """In-place views of the inputs and output on ``device``.

        The CPU gets ``torch.from_numpy`` views; a CUDA device gets the
        arrays page-locked and mapped (once per launch, memoized), each
        through a page-aligned copy unless it owns its pages
        (:func:`page_exclusive`); the output's copy is ``out_stage``.

        Returns:
            ``(input_views, out_view)``.
        """
        with self._lock:
            got = self._views.get(device.type)
            if got is not None:
                return got
            if device.type == "cpu":
                got = ([torch.from_numpy(np.asarray(a)) for a in self.inputs],
                       torch.from_numpy(self.out))
            else:
                arrays = [page_exclusive(np.asarray(a)) for a in self.inputs]
                if not owns_pages(self.out):
                    self.out_stage = page_exclusive(self.out)
                arrays.append(self.out if self.out_stage is None
                              else self.out_stage)
                self._held = arrays   # the views do not keep them alive
                mapped = []
                for a in arrays:
                    view, starts = _map_host(a, device)
                    self._mapped_starts.append(starts)
                    mapped.append(view)
                got = (mapped[:-1], mapped[-1])
            self._views[device.type] = got
            return got

    def release(self) -> None:
        """Drop the views and unmap the host ranges (idempotent)."""
        with self._lock:
            held, self._mapped_starts = self._mapped_starts, []
            arrays, self._held = self._held, []
            self._views.clear()
        for starts in held:
            _unmap_host(starts)
        del arrays                      # freed only once unmapped


@dataclasses.dataclass
class Pending:
    """One package in flight on a unit.

    Attributes:
        result: what the kernel body returned (the ``out`` it wrote).
        out: the output slot the body was given.
        event: CUDA event recorded on the unit's stream after the launch
            (``None`` on the CPU, where the body ran synchronously).
        host: BUFFERS only — the pinned host buffer the result is being
            copied back into on the unit's stream.
        copy_event: event recorded after that copy-back.
    """

    result: Any
    out: Optional[torch.Tensor] = None
    event: Optional[torch.cuda.Event] = None
    host: Optional[torch.Tensor] = None
    copy_event: Optional[torch.cuda.Event] = None


# ---------------------------------------------------------------------------
# Data planes
# ---------------------------------------------------------------------------

def _bucket(size: int) -> int:
    """Next power of two — the reference's compile-bucket staging size."""
    b = 1
    while b < size:
        b <<= 1
    return b


def _fill_split(buf: np.ndarray, arr: np.ndarray, spec: ArgSpec,
                offset: int, size: int, total: int) -> None:
    """Assemble one split chunk in place in a reused staging buffer.

    Interior slice, zero-filled halo at the edges, zero bucket pad, in a
    buffer whose split-axis extent is ``size + 2*halo + grow``.
    """
    lo = offset - spec.halo
    hi = offset + size + spec.halo
    lo_pad = max(0, -lo)
    index = [slice(None)] * arr.ndim
    index[spec.axis] = slice(max(lo, 0), min(hi, total))
    view = arr[tuple(index)]
    dst = [slice(None)] * buf.ndim
    dst[spec.axis] = slice(lo_pad, lo_pad + view.shape[spec.axis])
    buf.fill(0)
    buf[tuple(dst)] = view


class DataPlane:
    """Data-movement strategy for one memory model (template class).

    Subclasses implement :meth:`_stage` (how package inputs and the output
    slot reach the unit) and :meth:`_collect` (how the result lands in the
    launch's output container); :meth:`execute` runs the shared dispatch
    protocol and timestamps the package.
    """

    model: MemoryModel

    def plan(self, kernel: CoexecKernel, inputs: Sequence[np.ndarray],
             out: np.ndarray, total: int, units: Sequence = ()
             ) -> LaunchPlan:
        """Bind a launch's arrays to the kernel's declared arguments.

        Args:
            kernel: the typed kernel being launched.
            inputs: caller-supplied input arrays (defaults are filled).
            out: host output container (written along axis 0).
            total: launch index-space size.
            units: the units that will serve the launch; the USM plane
                prepares their in-place views now, as plan time.

        Returns:
            The launch's :class:`LaunchPlan`.

        Raises:
            ValueError: wrong argument count, or a split argument whose
                extent along its axis does not match ``total``.
        """
        bound = kernel.bind(inputs)
        for spec, arr in zip(kernel.args, bound):
            if spec.role is not ArgRole.SPLIT:
                continue
            extent = int(np.asarray(arr).shape[spec.axis])
            if extent != total:
                raise ValueError(
                    f"kernel {kernel.name!r} arg {spec.name!r} is SPLIT "
                    f"along axis {spec.axis} with extent {extent}, but the "
                    f"launch index space is {total}")
        plan = LaunchPlan(kernel, bound, out, total)
        try:
            self._attach(plan, units)
        except BaseException:
            plan.release()
            raise
        return plan

    def execute(self, unit, plan: LaunchPlan, pkg) -> None:
        """Run one package end to end on `unit` and commit its output.

        The serial (``pipeline_depth=1``) composition of :meth:`stage`,
        :meth:`issue` and :meth:`complete`. Sets ``pkg.t_launch`` /
        ``pkg.t_complete`` / ``pkg.t_collected`` and updates the plan's
        counters; the caller sets ``pkg.t_issue``.
        """
        with unit.stream_context():
            staged = self.stage(unit, plan, pkg)
            pending = self.issue(unit, plan, pkg, staged)
            self.complete(unit, plan, pkg, pending)

    def stage(self, unit, plan: LaunchPlan, pkg) -> tuple[list, Any]:
        """Phase 1 — materialize the package's inputs and output slot.

        Host-side work plus, under BUFFERS, asynchronous copies on the
        unit's stream; safe while an earlier package of the same unit is
        still computing.

        Returns:
            ``(args, out)`` for :meth:`issue`.
        """
        return self._stage(unit, plan, pkg)

    def issue(self, unit, plan: LaunchPlan, pkg, staged) -> Pending:
        """Phase 2 — launch the kernel on ``unit`` without waiting.

        Stamps ``pkg.t_launch`` and counts the dispatch; returns the
        in-flight :class:`Pending` whose completion :meth:`complete`
        awaits.
        """
        args, out = staged
        plan.add(dispatches=1)
        pkg.t_launch = time.perf_counter()
        return unit.dispatch(plan.kernel.fn, pkg.offset, args, out)

    def complete(self, unit, plan: LaunchPlan, pkg, pending: Pending, *,
                 busy_floor: float = 0.0) -> None:
        """Phase 3 — await the unit, attribute busy time, land output.

        Waits on the package's own CUDA event (never a device-wide
        synchronize, which would also wait on the other unit's work),
        charges the compute span to ``unit``, collects the result and
        stamps ``pkg.t_collected``.

        Args:
            unit: the unit that ran the package.
            plan: the launch's data-plane state.
            pkg: the package to complete.
            pending: the in-flight handle from :meth:`issue`.
            busy_floor: completion time of the unit's previous package;
                busy time is charged from ``max(t_launch, busy_floor)``
                so overlapped in-flight spans are not counted twice.

        Raises:
            TypeError: the kernel returned something that is not a
                tensor, which the pipelined plane cannot synchronize on.
        """
        if not isinstance(pending.result, torch.Tensor):
            raise TypeError(
                f"kernel {plan.kernel.name!r} returned "
                f"{type(pending.result).__name__!r}, which is not a "
                f"tensor; the pipelined data plane cannot synchronize on "
                f"it (kernels must write into `out` and return it)")
        if pending.event is not None:
            pending.event.synchronize()
        pkg.t_complete = time.perf_counter()
        unit.add_busy(pkg.t_complete - max(pkg.t_launch, busy_floor))
        self._collect(unit, plan, pkg, pending)
        pkg.t_collected = time.perf_counter()

    def prewarm(self, units: Sequence, plan: LaunchPlan,
                granularity: int) -> None:
        """Launch the kernel once per unit on a tiny input, untimed.

        What must stay out of ``busy_s`` on the card is the one-time
        library build and load and CUDA's lazy module load at the first
        launch; there is no per-shape compilation. Memoized per
        (kernel, unit). Best-effort: a kernel that fails here is left to
        the real dispatch, which fails the launch through its handle.

        Args:
            units: the engine's units.
            plan: the launch whose kernel to warm.
            granularity: rows of the warm-up package.
        """
        rows = max(int(granularity), 1)
        for unit in units:
            if unit.is_warm(plan.kernel):
                continue
            try:
                with unit.stream_context():
                    args = []
                    for spec, arr in zip(plan.kernel.args, plan.inputs):
                        arr = np.asarray(arr)
                        shape = list(arr.shape)
                        if spec.role is ArgRole.SPLIT:
                            shape[spec.axis] = rows + 2 * spec.halo
                        chunk = torch.zeros(shape,
                                            dtype=_torch_dtype(arr.dtype),
                                            device=unit.device)
                        args.append(HaloChunk(chunk, 0, 0) if spec.halo
                                    else chunk)
                    out = torch.empty((rows, *plan.trailing),
                                      dtype=_torch_dtype(plan.out.dtype),
                                      device=unit.device)
                    pending = unit.dispatch(plan.kernel.fn, 0, args, out)
                    if pending.event is not None:
                        pending.event.synchronize()
                unit.mark_warm(plan.kernel)
            except Exception:
                _log.debug("pre-warm of kernel %r skipped on %s; the first "
                           "dispatch will load it (or fail through its "
                           "handle)", plan.kernel.name, unit.name,
                           exc_info=True)
                return

    # -- subclass hooks ----------------------------------------------------
    def _attach(self, plan: LaunchPlan, units: Sequence) -> None:
        """Plan-time preparation for the serving units (default: none)."""

    def _stage(self, unit, plan: LaunchPlan, pkg) -> tuple[list, Any]:
        raise NotImplementedError

    def _collect(self, unit, plan: LaunchPlan, pkg, pending: Pending
                 ) -> None:
        raise NotImplementedError


class UsmDataPlane(DataPlane):
    """Unified-shared-memory data plane: zero staging copies.

    Every unit computes in place on the launch's host arrays — numpy
    views on the CPU, mapped page-locked memory on a CUDA unit — and
    writes its result straight into the launch's output rows, the paper's
    "collection is free" semantics (Fig. 2b). A halo that runs off the
    index space is passed as missing rows, never as a zero-filled copy,
    and no bucket padding is applied (nothing is compiled per shape).
    """

    model = MemoryModel.USM

    def _attach(self, plan: LaunchPlan, units: Sequence) -> None:
        for unit in units:
            plan.views(unit.device)

    def _stage(self, unit, plan: LaunchPlan, pkg) -> tuple[list, Any]:
        in_views, out_view = plan.views(unit.device)
        args = []
        for spec, view in zip(plan.kernel.args, in_views):
            if spec.role is not ArgRole.SPLIT:
                args.append(view)
                continue
            lo = pkg.offset - spec.halo
            hi = pkg.offset + pkg.size + spec.halo
            start, stop = max(lo, 0), min(hi, plan.total)
            chunk = view.narrow(spec.axis, start, stop - start)
            args.append(HaloChunk(chunk, start - lo, hi - stop) if spec.halo
                        else chunk)
        return args, out_view.narrow(0, pkg.offset, pkg.size)

    def _collect(self, unit, plan: LaunchPlan, pkg, pending: Pending
                 ) -> None:
        if pending.result.data_ptr() != pending.out.data_ptr():
            raise ValueError(f"kernel {plan.kernel.name!r} did not write "
                             f"its result into `out`")
        if plan.out_stage is not None and unit.device.type != "cpu":
            rows = slice(pkg.offset, pkg.offset + pkg.size)
            plan.out[rows] = plan.out_stage[rows]


class BuffersDataPlane(DataPlane):
    """Per-package buffers data plane: explicit staging in, copy-back out.

    Each package's split slices are assembled in host scratch — slice,
    zero-filled halo at the edges, zero pad up to the power-of-two size
    bucket, exactly the reference's staged values and byte counts — and
    copied to the unit; broadcast operands are copied per package (the
    paper's accessor-per-command-group cost), MatMul's whole ``B``
    included. On a CUDA unit the scratch is pinned and the copies run
    ``non_blocking`` on the unit's stream; the result is copied back into
    a pinned host buffer on the same stream and merged into the output
    container once its event completes. On the CPU each "copy" is a
    counted copy into a fresh tensor, as ``jax.device_put`` to the CPU
    device is in the reference.

    Scratch is pooled per ``(unit, shape, dtype)`` and stays leased until
    its package's event has completed, so pipelined staging of package
    *k+1* never overwrites a buffer whose asynchronous copy for package
    *k* may still be in flight. A unit's pool goes when the unit does.
    """

    model = MemoryModel.BUFFERS

    def __init__(self):
        # unit -> {(shape, dtype): [free buffers]}
        self._scratch = weakref.WeakKeyDictionary()  # guarded-by: _pool_lock
        self._leases: dict[tuple, list] = {}    # guarded-by: _pool_lock
        self._pool_lock = threading.Lock()

    def _borrow(self, unit, shape: tuple, dtype) -> tuple:
        key = (tuple(shape), np.dtype(dtype).str)
        with self._pool_lock:
            free = self._scratch.get(unit, {}).get(key)
            buf = free.pop() if free else None
        if buf is None:
            buf = torch.empty(tuple(shape), dtype=_torch_dtype(dtype),
                              pin_memory=unit.device.type == "cuda")
        return key, buf

    @staticmethod
    def _to_unit(host: torch.Tensor, unit) -> torch.Tensor:
        if unit.device.type == "cpu":
            return host.clone()
        return host.to(unit.device, non_blocking=host.is_pinned())

    def _stage(self, unit, plan: LaunchPlan, pkg) -> tuple[list, Any]:
        grow = _bucket(pkg.size) - pkg.size
        args, lease = [], []
        for spec, arr in zip(plan.kernel.args, plan.inputs):
            arr = np.asarray(arr)
            if spec.role is ArgRole.SPLIT:
                shape = list(arr.shape)
                shape[spec.axis] = pkg.size + 2 * spec.halo + grow
                key, buf = self._borrow(unit, shape, arr.dtype)
                _fill_split(buf.numpy(), arr, spec, pkg.offset, pkg.size,
                            plan.total)
                staged = self._to_unit(buf, unit)
                lease.append((key, buf))
                if spec.halo:
                    staged = HaloChunk(staged, 0, 0)
                nbytes = buf.numel() * buf.element_size()
            else:
                staged = self._to_unit(torch.from_numpy(arr), unit)
                nbytes = arr.nbytes
            plan.add(h2d_copies=1, h2d_bytes=nbytes)
            args.append(staged)
        if lease:
            with self._pool_lock:
                self._leases[(id(plan), pkg.seq)] = lease
        out = torch.empty((pkg.size + grow, *plan.trailing),
                          dtype=_torch_dtype(plan.out.dtype),
                          device=unit.device)
        return args, out

    def issue(self, unit, plan: LaunchPlan, pkg, staged) -> Pending:
        """Launch, then queue the copy-back behind it on the unit's stream."""
        pending = super().issue(unit, plan, pkg, staged)
        res = pending.result
        if unit.device.type == "cuda" and isinstance(res, torch.Tensor):
            pending.host = torch.empty(res.shape, dtype=res.dtype,
                                       pin_memory=True)
            pending.host.copy_(res, non_blocking=True)
            pending.copy_event = torch.cuda.Event()
            pending.copy_event.record(unit.stream)
        return pending

    def _collect(self, unit, plan: LaunchPlan, pkg, pending: Pending
                 ) -> None:
        if pending.host is not None:
            pending.copy_event.synchronize()
            host = pending.host
        else:
            host = pending.result.clone()
        plan.add(d2h_copies=1, d2h_bytes=host.numel() * host.element_size())
        plan.out[pkg.offset:pkg.offset + pkg.size] = \
            host.numpy()[:pkg.size]
        with self._pool_lock:
            pool = self._scratch.setdefault(unit, {})
            for key, buf in self._leases.pop((id(plan), pkg.seq), ()):
                pool.setdefault(key, []).append(buf)


_PLANES = {MemoryModel.USM: UsmDataPlane(),
           MemoryModel.BUFFERS: BuffersDataPlane()}


def make_plane(model: MemoryModel) -> DataPlane:
    """The data plane implementing one memory model.

    Args:
        model: USM or BUFFERS.

    Returns:
        The shared :class:`DataPlane` instance.

    Raises:
        KeyError: unknown memory model.
    """
    return _PLANES[model]
