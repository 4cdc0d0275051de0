"""Host arrays as the application holds them, and per-client seeds."""
from __future__ import annotations

import mmap

import numpy as np

_PAGE = mmap.PAGESIZE


def page_aligned_empty(shape, dtype) -> np.ndarray:
    """A C-contiguous array that starts on a page and owns its pages.

    The paper's application allocates its arrays for USM; an array that
    shares a page with another allocation would be copied at every launch
    rather than mapped in place.
    """
    dtype = np.dtype(dtype)
    shape = tuple(int(d) for d in np.atleast_1d(shape))
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    buf = np.empty(-(-nbytes // _PAGE) * _PAGE + _PAGE, np.uint8)
    start = -buf.ctypes.data % _PAGE
    return buf[start:start + nbytes].view(dtype).reshape(shape)


def to_host(tensor) -> np.ndarray:
    """A page-aligned host copy of a tensor (on any device)."""
    import torch

    dtype = torch.empty((), dtype=tensor.dtype).numpy().dtype
    host = page_aligned_empty(tuple(tensor.shape), dtype)
    torch.from_numpy(host).copy_(tensor)
    return host


def client_seed(seed: int, client: int, stream: int = 0) -> int:
    """A 64-bit seed for one client's stream, drawn from the run's seed."""
    state = np.random.SeedSequence([int(seed) % 2**64, int(client),
                                    int(stream)]).generate_state(1, np.uint64)
    return int(state[0])
