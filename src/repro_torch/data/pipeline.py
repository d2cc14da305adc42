"""Deterministic, restart-stable synthetic data pipeline with prefetch
(``repro.data.pipeline``, copied: it is plain numpy, and the port
imports nothing of the reference).

* Batch ``i`` is a pure function of ``(seed, i)`` (counter-based RNG),
  so the pipeline's state in a checkpoint is one integer cursor, and a
  resumed run consumes exactly the batches the interrupted one would.
* A background thread prefetches ``prefetch`` batches ahead.

The stream has Zipf-like marginals with local structure, so that a
language model's loss shows a learning signal.  Batches are numpy
arrays; the train step moves them to its device.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class TokenPipeline:
    def __init__(self, *, vocab_size: int, seq_len: int, batch: int,
                 seed: int = 0, start_step: int = 0, prefetch: int = 2):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- deterministic batch synthesis ---------------------------------
    def make_batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        v = self.vocab_size
        # Zipf-like marginal with local bigram structure.
        base = rng.zipf(1.5, size=(self.batch, self.seq_len + 1)) % v
        shift = rng.integers(0, 7, size=(self.batch, 1))
        seq = (base + shift) % v
        return {"tokens": seq[:, :-1].astype(np.int32),
                "labels": seq[:, 1:].astype(np.int32)}

    # -- prefetch loop --------------------------------------------------
    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.make_batch(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    # -- checkpoint integration -----------------------------------------
    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=1.0)


def latent_batch(step: int, *, batch: int, h: int, w: int, c: int = 4,
                 seed: int = 0) -> np.ndarray:
    """Deterministic synthetic latents for diffusion training/serving."""
    rng = np.random.default_rng((seed << 20) ^ (step + 0x5D))
    return rng.standard_normal((batch, h, w, c)).astype(np.float32)
