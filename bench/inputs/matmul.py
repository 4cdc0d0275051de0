"""MatMul's inputs: A (M x K) and B (K x N), normal(0, 1) in f32.

Drawn on the device from the seed in two calls a client, then copied to
page-aligned host arrays: the data lives on the host, as the paper's
application keeps it.
"""
from __future__ import annotations

import torch

from bench.harness.host import client_seed, to_host


def total(config: dict) -> int:
    """The launch's index space: A's rows."""
    return int(config["M"])


def make(config: dict, clients: int, seed: int, device: str) -> list:
    """One input set a client: ``[[a, b], ...]`` as host arrays."""
    M, N, K = int(config["M"]), int(config["N"]), int(config["K"])
    sets = []
    for c in range(clients):
        g = torch.Generator(device=device)
        g.manual_seed(client_seed(seed, c))
        a = torch.randn((M, K), generator=g, device=device,
                        dtype=torch.float32)
        b = torch.randn((K, N), generator=g, device=device,
                        dtype=torch.float32)
        sets.append([to_host(a), to_host(b)])
    return sets
