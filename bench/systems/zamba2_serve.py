"""Zamba2-7B-Instruct served by the port: one batch of requests a launch
through ``repro_torch.launch.serve.serve_batch`` (the prompts prefilled
through the flash and linear-attention kernels into the KV and SSD
caches, then one decode step a forced token), one worker thread, in
submission order.

Set-up asks the port's registry for ``zamba2-7b-instruct`` before
anything else (a port without it fails at once), builds the model from
the configuration's numbers and converts the shared weights to the port's
tree once (``params_from_zamba2_state_dict``: views, no copy). A handle's
``result()`` is the launch's f32 logits (B, G + 1, vocab), the batch's
requests on axis 0; its ``stats`` carry ``timeline()``, the launch's
spans (``launch``, ``prefill``, ``decode``) on ``time.perf_counter``.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import itertools
from typing import Optional, Sequence

import torch

ARCH = "zamba2-7b-instruct"


def port_config(config: dict):
    """The port's config of the configuration's numbers (the registered
    one at full size; the test size replaces its sizes)."""
    from repro_torch.configs import get_config

    return dataclasses.replace(
        get_config(ARCH), num_layers=config["num_hidden_layers"],
        d_model=config["hidden_size"],
        num_heads=config["num_attention_heads"],
        num_kv_heads=config["num_key_value_heads"],
        head_dim=config["attention_head_dim"],
        d_ff=config["intermediate_size"], vocab_size=config["vocab_size"],
        rope_theta=float(config["rope_theta"]),
        norm_eps=config["rms_norm_eps"], ssm_state=config["mamba_d_state"],
        ssm_head_dim=config["mamba_headdim"],
        hybrid_layer_ids=tuple(config["hybrid_layer_ids"]),
        num_mem_blocks=config["num_mem_blocks"],
        adapter_rank=config["adapter_rank"],
        mamba_ngroups=config["mamba_ngroups"])


class _Stats:
    """A launch's spans, the root first."""

    def __init__(self, spans: list):
        self.spans = spans

    def timeline(self) -> list:
        return list(self.spans)


class _Handle:
    """One launch: ``result()`` waits for its logits, then ``stats``."""

    def __init__(self, future):
        self._future = future
        self.stats = None

    def result(self, timeout=None):
        out, self.stats = self._future.result(timeout=timeout)
        return out


class System:
    """The port serving one cell's launches.

    Args:
        cell: the cell.
        inputs: one input set a client (the shared weights and model
            numbers, the client's prompts and forced tokens).
        total: a launch's index space (the batch).
        devices: the one unit's device; default the mix's ``units``.

    Raises:
        KeyError: the port has no ``zamba2-7b-instruct``.
    """

    def __init__(self, cell, inputs: list, total: int,
                 devices: Optional[Sequence[str]] = None):
        from repro_torch.configs import get_config

        get_config(ARCH)
        self.cell = cell
        self.inputs = inputs
        self.total = int(total)
        self.devices = list(devices or cell.traffic["units"])
        self._pool = None
        self._model = self._params = None
        self._ids = itertools.count()

    def start(self) -> None:
        """Build the model, convert the weights, start the worker."""
        from repro_torch.models import (build_model,
                                        params_from_zamba2_state_dict)

        cfg = port_config(self.cell.config)
        self._model = build_model(cfg)
        self._params = params_from_zamba2_state_dict(
            cfg, self.inputs[0]["weights"])
        self._pool = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="zamba2-serve")

    def _serve(self, launch: int, client: int):
        from repro_torch.launch.serve import serve_batch

        inputs = self.inputs[client]
        with torch.no_grad():
            logits, spans = serve_batch(
                self._model, self._params, inputs["prompts"],
                inputs["forced"], launch=launch)
        return logits, _Stats(spans)

    def submit(self, client: int) -> _Handle:
        """One launch of the client's batch; its handle."""
        return _Handle(self._pool.submit(self._serve, next(self._ids),
                                         client))

    def unit_kinds(self) -> dict:
        """Unit name -> device type."""
        return {d: torch.device(d).type for d in self.devices}

    def close(self) -> None:
        """Finish what was submitted, stop the worker, drop the tree."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        self._model = self._params = None
