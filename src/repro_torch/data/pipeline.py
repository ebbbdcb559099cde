"""Deterministic synthetic token pipeline (a copy of
``repro.data.pipeline``, numpy only: batch ``i`` is byte-equal to the
reference's).

Design points carried over from production pipelines:
  * deterministic resume — batch i is a pure function of (seed, i), so a
    restart from step k replays the exact stream (the elastic runtime relies
    on this after revocation/restart);
  * shard awareness — in a multi-host deployment each host generates only its
    slice (host_id/host_count offsets); this container is single-host but the
    slicing path is exercised by tests;
  * background prefetch with a bounded queue;
  * modality stubs per the assignment: audio yields precomputed frame
    embeddings + labels, vlm yields patch-embedding prefixes.

Tokens are Zipf-distributed with per-document Markov structure so tiny models
show decreasing loss in the integration tests (pure noise would not).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.config import ModelConfig


class SyntheticBatches:
    def __init__(self, cfg: ModelConfig, global_batch: int, seq_len: int,
                 seed: int = 0, host_id: int = 0, host_count: int = 1,
                 prefetch: int = 2):
        assert global_batch % host_count == 0
        self.cfg = cfg
        self.global_batch = global_batch
        self.local_batch = global_batch // host_count
        self.seq_len = seq_len
        self.seed = seed
        self.host_id = host_id
        self.host_count = host_count
        self.prefetch = prefetch

    # ------------------------------------------------------------- generation

    def _tokens(self, rng, b, s):
        v = self.cfg.vocab_size
        # zipf body + per-doc repeated motif (learnable structure)
        base = rng.zipf(1.3, size=(b, s)) % v
        motif_len = 8
        motif = rng.integers(0, v, size=(b, motif_len))
        reps = np.tile(motif, (1, s // motif_len + 1))[:, :s]
        use_motif = rng.random((b, s)) < 0.5
        return np.where(use_motif, reps, base).astype(np.int32)

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        """Batch ``index`` of this host's slice — pure function of inputs."""
        rng = np.random.default_rng(
            (self.seed, index, self.host_id))
        b, s, cfg = self.local_batch, self.seq_len, self.cfg
        if cfg.family == "audio":
            return {
                "embeds": rng.normal(size=(b, s, cfg.d_model)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            }
        if cfg.family == "vlm":
            P = cfg.prefix_len
            return {
                "prefix_embeds": rng.normal(size=(b, P, cfg.d_model)).astype(np.float32),
                "tokens": self._tokens(rng, b, s - P),
            }
        return {"tokens": self._tokens(rng, b, s)}

    # --------------------------------------------------------------- iterator

    def iterate(self, start: int = 0, prefetch: Optional[int] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Prefetching iterator starting at batch ``start``."""
        depth = self.prefetch if prefetch is None else prefetch
        if depth <= 0:
            i = start
            while True:
                yield self.batch(i)
                i += 1
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def worker():
            i = start
            while not stop.is_set():
                q.put(self.batch(i))
                i += 1

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
