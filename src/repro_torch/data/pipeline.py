"""Data pipeline: byte-level tokenizer, deterministic synthetic corpus or
file-backed text, host-sharded batching with background prefetch."""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Sequence

import numpy as np


class ByteTokenizer:
    """Byte-level tokenizer with a small reserved-special prefix."""

    PAD, BOS, EOS = 0, 1, 2
    OFFSET = 3

    @property
    def vocab_size(self) -> int:
        return 256 + self.OFFSET

    def encode(self, text: str) -> np.ndarray:
        return np.frombuffer(text.encode("utf-8"), np.uint8).astype(np.int32) + self.OFFSET

    def decode(self, ids: Sequence[int]) -> str:
        arr = np.asarray([i - self.OFFSET for i in ids if i >= self.OFFSET], np.uint8)
        return arr.tobytes().decode("utf-8", errors="replace")


def synthetic_corpus(seed: int = 0, n_docs: int = 256) -> Iterator[str]:
    """Deterministic pseudo-text: Zipf-ish word soup with structure so a
    small LM's loss visibly drops within a few hundred steps."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(200)]
    probs = 1.0 / np.arange(1, len(words) + 1)
    probs /= probs.sum()
    for _ in range(n_docs):
        n = int(rng.integers(64, 256))
        idx = rng.choice(len(words), size=n, p=probs)
        # inject bigram structure: every 'w0' is followed by 'w1'
        toks = []
        for i in idx:
            toks.append(words[i])
            if i == 0:
                toks.append(words[1])
        yield " ".join(toks)


class LMDataset:
    """Packs a token stream into (tokens, labels) windows; deterministically
    shards across data-parallel hosts (shard `host_id` of `num_hosts`)."""

    def __init__(
        self,
        seq_len: int,
        batch_size: int,
        vocab_size: int,
        seed: int = 0,
        corpus: Optional[Iterator[str]] = None,
        host_id: int = 0,
        num_hosts: int = 1,
    ):
        tok = ByteTokenizer()
        ids = []
        for doc in corpus if corpus is not None else synthetic_corpus(seed):
            ids.append(tok.encode(doc) % vocab_size)
            ids.append(np.array([tok.EOS], np.int32))
        stream = np.concatenate(ids)
        n_win = len(stream) // (seq_len + 1)
        stream = stream[: n_win * (seq_len + 1)].reshape(n_win, seq_len + 1)
        self.windows = stream[host_id::num_hosts]
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.rng = np.random.default_rng(seed + host_id)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            idx = self.rng.integers(0, len(self.windows), self.batch_size)
            w = self.windows[idx]
            yield {"tokens": w[:, :-1].astype(np.int32), "labels": w[:, 1:].astype(np.int32)}


class Prefetcher:
    """Background-thread prefetch (depth-bounded) over any batch iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._it = iter(it)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
