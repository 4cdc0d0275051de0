"""Zamba2-7B-Instruct's work, counted from its shapes: a launch is a batch
of B requests, each a P-token prompt prefilled, then G decode steps.

Operations (``count``): every matrix product at 2 m n k (each Mamba
layer's in and out projections; each hybrid application's q, k, v, o, the
MLP's gate-up, LoRA and down, and its linear), the LM head at the G + 1
positions whose logits a launch returns, causal attention at 4 H D per
(query, reachable key) pair (prefill: P (P + 1) / 2 pairs a sequence;
decode: t + 1 at position t), and the SSD's recurrence at 5 N P_head a
(head, step) (the state's decay and update and its read-out). Elementwise
work (norms, conv, gates) is not counted.

Bytes (the least HBM traffic): every weight read once by the prefill and
once by each decode step; the K and V caches written once and read by
each decode step up to its position; the SSD states written by the
prefill and read and written by each decode step; the f32 logits
written. Weights count once whatever the range of requests; the rest in
proportion to it.

``count_part`` gives one kernel's part of a launch: ``flash_attention``
(the hybrid applications' prefill attention: q, k, v read, the output
written) and ``ssd`` (the Mamba layers' prefill scans: each head's x and
log-decay read and its output and final f32 state written; B and C read
once for each group, whose heads share them, with dt carried by the
log-decay).
"""
from __future__ import annotations

PEAK = "bf16_dense_flops_per_s"
F32 = 4


def items(config: dict) -> int:
    """Tokens a launch: B (P + G)."""
    return int(config["batch"]) * (int(config["prompt_len"])
                                   + int(config["decode_steps"]))


class Counter:
    """Operations and bytes of any range of one client's batch."""

    def __init__(self, inputs: dict, device: str = "cpu"):
        m = inputs["model"]
        w = inputs["weights"]
        self.P = int(inputs["prompts"].shape[1])
        self.G = int(inputs["forced"].shape[1])
        self.b = next(iter(w.values())).element_size()
        self.weight_bytes = sum(t.numel() * t.element_size()
                                for t in w.values())
        d, V = m["hidden_size"], m["vocab_size"]
        self.d, self.V = d, V
        self.L, self.apps = m["num_hidden_layers"], len(m["hybrid_layer_ids"])
        self.HD = m["num_attention_heads"] * m["attention_head_dim"]
        self.KVD = m["num_key_value_heads"] * m["attention_head_dim"]
        a, ff, r = (m["attention_hidden_size"], m["intermediate_size"],
                    m["adapter_rank"])
        d_in = m["mamba_expand"] * d
        self.Hm, self.N = m["n_mamba_heads"], m["mamba_d_state"]
        self.Pm = m["mamba_headdim"]
        gn = m["mamba_ngroups"] * self.N
        self.gn = gn
        mamba = 2 * d * (2 * d_in + 2 * gn + self.Hm) + 2 * d_in * d
        shared = (2 * a * (self.HD + 2 * self.KVD) + 2 * self.HD * d
                  + 2 * d * 2 * ff + 2 * r * (d + 2 * ff) + 2 * ff * d
                  + 2 * d * d)
        # matrix products a token, and the SSD recurrence a token
        self.token_ops = self.L * mamba + self.apps * shared
        self.ssd_token_ops = self.L * self.Hm * 5 * self.N * self.Pm
        self.state_bytes = self.L * self.Hm * self.N * self.Pm * F32

    def _attn_pairs(self) -> int:
        """(query, key) pairs a sequence: the prefill's causal half, then
        each decode step's keys up to its own position."""
        P, G = self.P, self.G
        return P * (P + 1) // 2 + sum(P + i + 1 for i in range(G))

    def count_part(self, kernel: str, offset: int, size: int
                   ) -> tuple[int, int]:
        """``(operations, bytes)`` of ``kernel``'s prefill launches over
        requests [offset, offset + size)."""
        P, b = self.P, self.b
        if kernel == "flash_attention":
            ops = self.apps * size * 4 * self.HD * (P * (P + 1) // 2)
            nbytes = self.apps * size * P * b * (2 * self.HD
                                                 + 2 * self.KVD)
            return ops, nbytes
        if kernel == "ssd":
            ops = size * P * self.ssd_token_ops
            rows = self.L * size * self.Hm
            nbytes = (rows * (P * (b * 2 * self.Pm + F32)
                              + self.N * self.Pm * F32)
                      + self.L * size * P * 2 * self.gn * b)
            return ops, nbytes
        raise KeyError(f"no kernel {kernel!r}; choose flash_attention or "
                       f"ssd")

    def count(self, offset: int, size: int) -> tuple[int, int]:
        """``(operations, bytes)`` of requests [offset, offset + size)."""
        P, G, b = self.P, self.G, self.b
        tokens = size * (P + G)
        ops = (tokens * (self.token_ops + self.ssd_token_ops)
               + size * (G + 1) * 2 * self.d * self.V
               + self.apps * size * 4 * self.HD * self._attn_pairs())
        kv_written = self.apps * size * (P + G) * 2 * self.KVD * b
        kv_read = self.apps * size * 2 * self.KVD * b * sum(
            P + i + 1 for i in range(G))
        nbytes = ((G + 1) * self.weight_bytes + kv_written + kv_read
                  + size * self.state_bytes * (1 + 2 * G)
                  + size * (G + 1) * self.V * F32)
        return ops, nbytes
