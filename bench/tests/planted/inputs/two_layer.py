"""The planted two-layer model's inputs: its weights, which every client
shares, and one batch of requests a client, drawn on the device from the
seed in the configuration's ``dtype``; they stay on the device."""
from __future__ import annotations

import torch

from bench.harness.host import client_seed

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def total(config: dict) -> int:
    """The launch's index space: the batch's requests."""
    return int(config["batch"])


def make(config: dict, clients: int, seed: int, device: str) -> list:
    """``[{"weights": {"w1", "w2"}, "x": requests}, ...]``, one a client,
    the weights the same tensors in every client's set."""
    dtype = DTYPES[config["dtype"]]
    B, D, H, V = (int(config[k]) for k in ("batch", "d_model", "d_hidden",
                                           "vocab"))
    g = torch.Generator(device=device)
    g.manual_seed(client_seed(seed, 0, stream=2))
    weights = {
        "w1": (torch.randn((D, H), generator=g, device=device)
               * D ** -0.5).to(dtype),
        "w2": (torch.randn((H, V), generator=g, device=device)
               * H ** -0.5).to(dtype)}
    sets = []
    for c in range(clients):
        g.manual_seed(client_seed(seed, c))
        sets.append({"weights": weights,
                     "x": torch.randn((B, D), generator=g,
                                      device=device).to(dtype)})
    return sets
