"""Synthetic, deterministic, restartable data pipeline.

Batches are a pure function of ``(seed, step)`` via a counter-based PRNG —
any host can materialize its own slice of any global batch without
coordination, which gives:

  * per-host sharded loading (host h materializes rows [h*B/H, (h+1)*B/H));
  * exact restart after preemption/failure (no data-loader state to save
    beyond the step counter);
  * elastic rescale (a new host count re-slices the same global batch).

Token streams are Zipf-distributed over the vocab (more realistic branch
behaviour in the loss than uniform) with a small amount of repeated-ngram
structure so the loss actually decreases during the example runs.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    structure: float = 0.5  # fraction of positions copied from earlier context


class SyntheticPipeline:
    def __init__(self, cfg: DataConfig, host_index: int = 0, host_count: int = 1):
        if cfg.global_batch % host_count:
            raise ValueError("global_batch must divide host_count")
        self.cfg = cfg
        self.host_index = host_index
        self.host_count = host_count
        self.local_batch = cfg.global_batch // host_count

    def _rng(self, step: int) -> np.random.Generator:
        # counter-based: independent stream per (seed, step)
        return np.random.Generator(
            np.random.Philox(key=self.cfg.seed, counter=[0, 0, 0, step])
        )

    def global_batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        """(tokens, labels) of shape (global_batch, seq_len) at ``step``."""
        c = self.cfg
        rng = self._rng(step)
        n = c.global_batch * (c.seq_len + 1)
        draws = rng.zipf(c.zipf_a, size=n).astype(np.int64)
        toks = (draws - 1) % max(c.vocab_size - 2, 1) + 1  # reserve 0 for BOS
        toks = toks.reshape(c.global_batch, c.seq_len + 1).astype(np.int32)
        toks[:, 0] = 0
        # inject copied spans => learnable structure
        span = max(c.seq_len // 16, 1)
        n_copies = int(c.structure * c.seq_len / span)
        for _ in range(n_copies):
            src = rng.integers(0, c.seq_len - span)
            dst = rng.integers(src + 1, c.seq_len - span + 1)
            toks[:, dst : dst + span] = toks[:, src : src + span]
        return toks[:, :-1], toks[:, 1:]

    def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        """This host's slice of the global batch at ``step``."""
        tokens, labels = self.global_batch_at(step)
        lo = self.host_index * self.local_batch
        hi = lo + self.local_batch
        return tokens[lo:hi], labels[lo:hi]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
