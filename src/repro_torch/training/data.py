"""Data pipeline: synthetic deterministic token stream + binary file loader.

Per-host sharding: each process takes a contiguous slice of the global
batch (process_index / process_count); the arrays produced here are the
per-host shard that ``jax.make_array_from_process_local_data`` would
assemble on a real multi-host deployment.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np


@dataclasses.dataclass
class DataConfig:
    seq_len: int = 512
    global_batch: int = 8
    vocab_size: int = 32000
    seed: int = 1234
    path: str | None = None          # .bin of uint16/uint32 tokens
    process_index: int = 0
    process_count: int = 1


class TokenStream:
    """Deterministic synthetic corpus: Zipf-distributed tokens with
    long-range repeats so the loss is learnable (a model can beat the
    unigram entropy by copying)."""

    def __init__(self, dcfg: DataConfig, extra_features=None):
        self.cfg = dcfg
        self.extra = extra_features or {}
        if dcfg.path:
            raw = np.fromfile(dcfg.path, dtype=np.uint16).astype(np.int32)
            self._corpus = raw % dcfg.vocab_size
        else:
            rng = np.random.default_rng(dcfg.seed)
            n = max(1_000_000, 4 * dcfg.seq_len * dcfg.global_batch)
            zipf = rng.zipf(1.3, size=n).astype(np.int64)
            base = (zipf % max(dcfg.vocab_size - 2, 1)) + 1
            # inject copy structure: every 128 tokens repeat the previous 64
            base[128::128] = base[64::128][: len(base[128::128])]
            self._corpus = base.astype(np.int32)
        assert dcfg.global_batch % dcfg.process_count == 0
        self._local_batch = dcfg.global_batch // dcfg.process_count
        self._step = 0

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        d = self.cfg
        B, S = self._local_batch, d.seq_len
        n = len(self._corpus)
        out = np.empty((B, S + 1), np.int32)
        for i in range(B):
            gidx = self._step * d.global_batch \
                + d.process_index * B + i
            start = (gidx * (S + 1)) % (n - S - 2)
            out[i] = self._corpus[start : start + S + 1]
        self._step += 1
        batch = {
            "tokens": out[:, :-1],
            "targets": out[:, 1:],
            "mask": np.ones((B, S), np.float32),
        }
        rng = np.random.default_rng(d.seed + 7919 * self._step)
        for name, shape_dtype in self.extra.items():
            shape, dtype = shape_dtype
            batch[name] = rng.standard_normal((B, *shape)).astype(dtype) * 0.1
        return batch


def write_token_file(path: str | pathlib.Path, tokens: np.ndarray):
    np.asarray(tokens, dtype=np.uint16).tofile(str(path))
