"""Deterministic, sharded, resumable data pipeline (a copy of
``repro.data.pipeline``, numpy only: the same batches in both packages).

Every batch is a pure function of (seed, step, shard) — a restart after a
failure resumes bit-exactly from the checkpointed step with no data replay
or skip, and elastic re-sharding (different n_shards) keeps coverage.
A background prefetch thread hides host-side batch assembly.
"""
from __future__ import annotations

import queue
import threading

import numpy as np


class DataPipeline:
    def __init__(self, tokens: np.ndarray, *, batch_size: int, seq_len: int,
                 shard_id: int = 0, n_shards: int = 1, seed: int = 0,
                 prefetch: int = 2):
        assert batch_size % n_shards == 0
        self.tokens = tokens
        self.batch = batch_size
        self.local_batch = batch_size // n_shards
        self.seq = seq_len
        self.shard_id = shard_id
        self.n_shards = n_shards
        self.seed = seed
        self.n_windows = max(1, (len(tokens) - 1) // seq_len)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._thread = None
        self._stop = threading.Event()

    def batch_at(self, step: int) -> dict:
        """Pure: the global batch for `step`, restricted to this shard."""
        rng = np.random.default_rng((self.seed, step))
        idx = rng.integers(0, self.n_windows, size=self.batch)
        idx = idx[self.shard_id * self.local_batch:
                  (self.shard_id + 1) * self.local_batch]
        starts = idx * self.seq
        toks = np.stack([self.tokens[s:s + self.seq] for s in starts])
        labels = np.stack([self.tokens[s + 1:s + self.seq + 1] for s in starts])
        return {"tokens": toks.astype(np.int32),
                "labels": labels.astype(np.int32)}

    # ----------------------------------------------------- prefetch iterator
    def start(self, start_step: int):
        self._stop.clear()

        def work():
            step = start_step
            while not self._stop.is_set():
                b = self.batch_at(step)
                while not self._stop.is_set():
                    try:
                        self._q.put((step, b), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def next(self) -> tuple[int, dict]:
        return self._q.get()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        while not self._q.empty():
            self._q.get_nowait()
