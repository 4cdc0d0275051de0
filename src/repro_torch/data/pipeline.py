"""Deterministic sharded synthetic token pipeline with host prefetch.

The port's own copy of the reference's numpy-only pipeline (the port
imports nothing of the reference), so both packages' batches are equal bit
for bit for any (seed, step, shard).

Every (step, shard) cell is derived from a counter-based hash of
(seed, step, shard_index), so:
  * restarting from a checkpoint reproduces the exact token stream
    (the fault-tolerance invariant the supervisor's replay relies on),
  * each data-parallel group reads only its shard (no host hot-spotting),
  * elastic resharding (G → G') re-partitions the same global stream.

A background thread keeps `prefetch` batches ahead of the training loop,
overlapping host batch synthesis with device compute — the data-pipeline
analogue of the Commander loop's compute/communication overlap.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


def _batch_for(seed: int, step: int, shard: int, num_shards: int,
               batch_per_shard: int, seq_len: int, vocab: int
               ) -> dict[str, np.ndarray]:
    """Counter-based deterministic batch (Philox keyed by cell)."""
    key = np.uint64(seed) * np.uint64(1_000_003) + \
        np.uint64(step) * np.uint64(num_shards) + np.uint64(shard)
    rng = np.random.Generator(np.random.Philox(key=int(key)))
    # Markov-ish synthetic text: mixture of a few token "topics" per row
    # (gives a learnable distribution so e2e training loss decreases).
    topics = rng.integers(0, 8, size=(batch_per_shard, 1))
    base = (topics * (vocab // 8) +
            rng.integers(0, max(vocab // 8, 1),
                         size=(batch_per_shard, seq_len + 1)))
    tokens = np.asarray(base % vocab, dtype=np.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


class DataPipeline:
    """Sharded deterministic stream: `it = pipeline.shard_iterator(i)`."""

    def __init__(self, *, seed: int, global_batch: int, seq_len: int,
                 vocab: int, num_shards: int = 1, prefetch: int = 2,
                 start_step: int = 0):
        if global_batch % num_shards:
            raise ValueError("global_batch must divide into shards")
        self.seed = seed
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.vocab = vocab
        self.num_shards = num_shards
        self.prefetch = prefetch
        self.start_step = start_step

    def batch_at(self, step: int, shard: int = 0,
                 batch_override: Optional[int] = None) -> dict:
        bsz = batch_override or self.global_batch // self.num_shards
        return _batch_for(self.seed, step, shard, self.num_shards,
                          bsz, self.seq_len, self.vocab)

    def shard_iterator(self, shard: int = 0) -> Iterator[dict]:
        """Prefetching iterator for one shard, resumable at start_step."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            step = self.start_step
            while not stop.is_set():
                batch = self.batch_at(step, shard)
                while not stop.is_set():
                    try:
                        q.put((step, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                step, batch = q.get()
                yield batch
        finally:
            stop.set()

    def reshard(self, num_shards: int, start_step: int) -> "DataPipeline":
        """Elastic re-partitioning of the same global stream."""
        return DataPipeline(seed=self.seed, global_batch=self.global_batch,
                            seq_len=self.seq_len, vocab=self.vocab,
                            num_shards=num_shards, prefetch=self.prefetch,
                            start_step=start_step)
