"""Deterministic, resumable token data pipeline: the port's copy of
``repro.data.pipeline`` (numpy only, no JAX), kept line for line so one
seed gives the reference's batches (``tests/test_torch_train.py`` checks).

Design goals (scaled-down but structurally faithful to a production pipeline):
  * deterministic as a pure function of (seed, step) — a restored checkpoint
    resumes the exact token stream with no iterator pickling,
  * per-host sharding: each host materializes only its slice of the global
    batch (``host_slice``; single-host here, but the API is
    multi-host-shaped),
  * sequence packing: documents shorter than seq_len are packed back-to-back
    with EOS separators and a loss mask that blanks cross-document positions,
  * background prefetch with a bounded queue (overlaps host data work with
    device steps).

Two sources: ``SyntheticLM`` (a mixture of deterministic pattern generators —
copy/induction/ngram — hard enough that loss decrease is meaningful) and
``TokenFile`` (memory-mapped flat token array, the standard pretokenized
binary format).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    seq_len: int = 256
    global_batch: int = 8
    vocab_size: int = 256
    seed: int = 0
    source: str = "synthetic"      # synthetic | file
    path: Optional[str] = None     # for source=file (np.uint16/uint32 tokens)
    pack_documents: bool = True
    eos_id: int = 0
    # host sharding
    host_index: int = 0
    host_count: int = 1

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.host_count == 0
        return self.global_batch // self.host_count


class SyntheticLM:
    """Deterministic synthetic LM task: each document is one of
      * copy:      prefix | SEP | prefix  (second half predictable)
      * induction: random pairs (a b) repeated, so 'a' predicts 'b'
      * ngram:     order-2 markov chain with a per-document transition table
    A model that learns reduces loss well below the uniform baseline."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def document(self, rng: np.random.Generator) -> np.ndarray:
        c = self.cfg
        v = c.vocab_size
        kind = rng.integers(0, 3)
        length = int(rng.integers(c.seq_len // 4, c.seq_len + 1))
        if kind == 0:  # copy
            half = max(2, length // 2)
            prefix = rng.integers(2, v, size=half)
            return np.concatenate([prefix, [1], prefix])[: length].astype(np.int32)
        if kind == 1:  # induction pairs
            n_pairs = max(2, v // 16)
            a = rng.integers(2, v, size=n_pairs)
            b = rng.integers(2, v, size=n_pairs)
            idx = rng.integers(0, n_pairs, size=length // 2 + 1)
            doc = np.stack([a[idx], b[idx]], axis=1).reshape(-1)
            return doc[:length].astype(np.int32)
        # order-1 markov: sharp per-document transition table
        nxt = rng.integers(2, v, size=v)
        doc = np.empty(length, np.int32)
        doc[0] = rng.integers(2, v)
        for i in range(1, length):
            doc[i] = nxt[doc[i - 1]] if rng.random() < 0.9 else rng.integers(2, v)
        return doc


class TokenFile:
    def __init__(self, cfg: DataConfig):
        assert cfg.path, "source=file needs a path"
        self.tokens = np.memmap(cfg.path, dtype=np.uint16, mode="r")
        self.cfg = cfg

    def document(self, rng: np.random.Generator) -> np.ndarray:
        c = self.cfg
        n = len(self.tokens)
        start = int(rng.integers(0, max(1, n - c.seq_len - 1)))
        return np.asarray(
            self.tokens[start : start + c.seq_len + 1], dtype=np.int32
        )


def _pack_sequence(source, rng, seq_len: int, eos: int):
    """Pack documents into one (tokens[seq_len+1], seg_ids[seq_len+1]) row."""
    toks: list[np.ndarray] = []
    segs: list[np.ndarray] = []
    seg = 0
    total = 0
    while total < seq_len + 1:
        doc = source.document(rng)
        doc = np.concatenate([doc, [eos]])
        toks.append(doc)
        segs.append(np.full(len(doc), seg, np.int32))
        total += len(doc)
        seg += 1
    t = np.concatenate(toks)[: seq_len + 1]
    s = np.concatenate(segs)[: seq_len + 1]
    return t, s


def batch_at_step(cfg: DataConfig, step: int, host_slice: bool = True) -> dict:
    """The batch for a given step — pure function of (cfg.seed, step).
    Returns {"tokens","targets","mask"} of host-local (or global) batch."""
    src = SyntheticLM(cfg) if cfg.source == "synthetic" else TokenFile(cfg)
    if host_slice:
        rows = range(
            cfg.host_index * cfg.host_batch, (cfg.host_index + 1) * cfg.host_batch
        )
    else:
        rows = range(cfg.global_batch)
    tokens, targets, mask = [], [], []
    for r in rows:
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, r])
        )
        t, s = _pack_sequence(src, rng, cfg.seq_len, cfg.eos_id)
        tokens.append(t[:-1])
        targets.append(t[1:])
        # mask cross-document boundaries (target in a different segment)
        mask.append((s[1:] == s[:-1]).astype(np.float32))
    return {
        "tokens": np.stack(tokens),
        "targets": np.stack(targets),
        "mask": np.stack(mask),
    }


class Prefetcher:
    """Bounded-queue background prefetch keyed by step — resumable by
    construction (state is just the next step index)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2):
        self.cfg = cfg
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._next = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._next
        while not self._stop.is_set():
            batch = batch_at_step(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self) -> tuple[int, dict]:
        return self._q.get()

    def close(self):
        self._stop.set()
