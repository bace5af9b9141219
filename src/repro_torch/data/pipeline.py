"""Deterministic sharded data pipeline (the reference's
``data/pipeline.py``).

Synthetic LM tokens from a counter-mode hash (splitmix64), a pure function
of (seed, step, row, position): any host materialises exactly its shard,
and a restart resumes bit for bit from the step counter alone (no data
state in checkpoints). Batches are numpy arrays, bit for bit the
reference's; the train loop puts them on its device. A background thread
prefetches the next batches while the current step runs.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

__all__ = ["SyntheticTokens", "make_batches"]


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


class SyntheticTokens:
    """Deterministic synthetic token stream of a (possibly multi-host) job:
    host ``host_rank`` of ``host_count`` (default 0 of 1) emits rows
    [host_rank * per_host, (host_rank + 1) * per_host) of the global batch.
    ``extras`` maps a frontend stub's name ("frames", "vision") to its
    (length, dim): deterministic pseudo-embeddings; "vision" also shortens
    tokens and labels by its length."""

    def __init__(self, vocab: int, global_batch: int, seq_len: int,
                 seed: int = 0, host_rank: int | None = None,
                 host_count: int | None = None, extras: dict | None = None):
        self.vocab = int(vocab)
        self.global_batch = int(global_batch)
        self.seq_len = int(seq_len)
        self.seed = np.uint64(seed)
        self.rank = 0 if host_rank is None else host_rank
        self.count = 1 if host_count is None else host_count
        if self.global_batch % self.count:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {self.count} hosts")
        self.per_host = self.global_batch // self.count
        self.extras = extras or {}

    def batch(self, step: int) -> dict:
        rows = (self.rank * self.per_host
                + np.arange(self.per_host, dtype=np.uint64))
        pos = np.arange(self.seq_len + 1, dtype=np.uint64)
        key = (self.seed * np.uint64(0x100000001)
               + np.uint64(step) * np.uint64(0x51_7CC1B7)
               + rows[:, None] * np.uint64(0x2545F491_4F6CDD1D)
               + pos[None, :])
        noise = _splitmix64(key)
        # A learnable Markov source: t_{i+1} = (5 t_i + 7) mod V with
        # probability 7/8, uniform noise otherwise.
        V = np.uint64(self.vocab)
        toks = np.empty((self.per_host, self.seq_len + 1), np.int32)
        toks[:, 0] = (noise[:, 0] % V).astype(np.int32)
        rnd_tok = (noise % V).astype(np.int32)
        use_rnd = ((noise >> np.uint64(33)) % np.uint64(8)) == 0
        for i in range(1, self.seq_len + 1):
            pred = (toks[:, i - 1].astype(np.int64) * 5 + 7) % self.vocab
            toks[:, i] = np.where(use_rnd[:, i], rnd_tok[:, i],
                                  pred.astype(np.int32))
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        for name, (length, dim) in self.extras.items():
            g = np.arange(length * dim, dtype=np.uint64).reshape(length, dim)
            e = _splitmix64(g + np.uint64(step)).astype(np.float64)
            e = (e / 2**64 - 0.5).astype(np.float32) * 0.02
            out[name] = np.broadcast_to(e, (self.per_host, length, dim)).copy()
            if name == "vision":
                out["tokens"] = out["tokens"][:, :-length]
                out["labels"] = out["labels"][:, :-length]
        return out


def make_batches(ds: SyntheticTokens, start_step: int, n_steps: int,
                 prefetch: int = 2):
    """Prefetching iterator of (step, batch) over
    [start_step, start_step + n_steps)."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)

    def producer():
        for s in range(start_step, start_step + n_steps):
            q.put((s, ds.batch(s)))
        q.put(None)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is None:
            return
        yield item
