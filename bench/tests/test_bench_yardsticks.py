"""The frozen yardsticks: the work counts equal direct counts, and the
plain references agree with direct NumPy, at small sizes."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import ROOT, cell_names, small_cell


def test_matmul_counts_equal_direct_counts():
    cell = small_cell("matmul-t1.pair-usm")
    a, b = cell.module("inputs").make(cell.config, 1, 5, "cpu")[0]
    counter = cell.module("work").Counter([a, b])
    M, K = a.shape
    N = b.shape[1]
    for off, size in ((0, M), (3, 7), (M - 1, 1)):
        ops, nbytes = counter.count(off, size)
        # one multiply and one add for every (row, column, k)
        assert ops == sum(2 * N * K for _ in range(size))
        assert nbytes == (a[off:off + size].nbytes + b.nbytes
                          + size * N * 4)
    assert cell.module("work").items(cell.config) == M * N


def test_matmul_reference_agrees_with_numpy():
    cell = small_cell("matmul-t1.pair-usm")
    a, b = cell.module("inputs").make(cell.config, 1, 9, "cpu")[0]
    ref = cell.module("reference")
    want = a.astype(np.float64) @ b.astype(np.float64)
    got = ref.reference([a, b], "cpu").numpy()
    assert np.abs(got - want).max() / np.sqrt((want ** 2).mean()) < 1e-5
    assert ref.compare(got, torch.from_numpy(want.astype(np.float32))
                       )["max_err_over_rms"] < 1e-5


def test_round_tf32_keeps_ten_mantissa_bits_to_nearest():
    from bench.harness import spec

    ref = spec.load_module(ROOT / "bench" / "reference" / "matmul.py")
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-10 + 2**-12,
                      -(1.0 + 3 * 2**-11), 3.0])
    want = torch.tensor([1.0, 1.0 + 2**-9, 1.0 + 2**-10, -(1.0 + 2**-9), 3.0])
    assert torch.equal(ref.round_tf32(x), want)


def flatten(tree, path=()) -> list:
    """``(path, leaf)`` of nested dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree) for x in flatten(t, path + (i,))]
    return [(path, tree)]


def same(one, two) -> bool:
    """The same structure, and every leaf equal (dtype and values)."""
    a, b = flatten(one), flatten(two)
    if [p for p, _ in a] != [p for p, _ in b]:
        return False
    for (_, x), (_, y) in zip(a, b):
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            x, y = torch.as_tensor(x), torch.as_tensor(y)
            if x.dtype != y.dtype or not torch.equal(x, y.to(x.device)):
                return False
        elif not np.array_equal(x, y):
            return False
    return True


@pytest.mark.parametrize("name", cell_names())
def test_the_same_seed_makes_the_same_inputs(name, root=ROOT):
    cell = small_cell(name, root)
    make = cell.module("inputs").make
    one, two = make(cell.config, 2, 77, "cpu"), make(cell.config, 2, 77, "cpu")
    other = make(cell.config, 2, 78, "cpu")
    if all(isinstance(leaf, np.ndarray) for _, leaf in flatten(one)):
        # data on the host, as the co-execution runtime's application
        # keeps it: every array the client's own
        for a, b in zip(one[0] + one[1], two[0] + two[1]):
            assert np.array_equal(a, b)
        assert not np.array_equal(one[0][0], one[1][0])      # clients differ
        assert not np.array_equal(one[0][0], other[0][0])    # seeds differ
        for arr in one[0]:
            assert arr.ctypes.data % 4096 == 0               # page-aligned
        return
    # any other structure, such as weights every client shares beside each
    # client's own requests: leaf by leaf
    assert same(one, two)
    assert not same(one[0], one[1])                      # clients differ
    assert not same(one, other)                          # seeds differ
