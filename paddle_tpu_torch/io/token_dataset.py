"""TokenFileDataset (``paddle_tpu/io/token_dataset.py``): the native LM
data feed, ``csrc/datafeed/datafeed.cpp``, loaded through the port's
``utils.cpp_extension.load_native`` (built with g++ from the source as
it stands, into the git-ignored build directory, at first use; the JAX
package's ``paddle_tpu/lib`` build is never read).

A corpus pre-tokenised to a flat binary int32 file (``write_token_file``)
is cut into windows of ``seq_len + 1`` tokens; C++ worker threads copy
``batch_size`` windows a batch (in a bijective shuffle of the windows
per (seed, epoch) when `shuffle`) into a bounded queue, in order.  Each
item is ``{"input_ids": [B, S], "labels": [B, S]}``, int32 numpy, the
labels the window shifted by one.  An iteration yields ``epochs``
epochs; the feed goes on from where the last iteration stopped.  The
threads run until :meth:`close` (or collection)."""

from __future__ import annotations

import ctypes
import os
from typing import Iterator

import numpy as np

from paddle_tpu_torch.io.dataset import IterableDataset

__all__ = ["TokenFileDataset", "write_token_file"]


def write_token_file(path: str, tokens) -> str:
    """Helper: dump an int sequence to the flat int32 format."""
    arr = np.asarray(tokens, np.int32)
    arr.tofile(path)
    return path


def _lib():
    from paddle_tpu_torch.utils.cpp_extension import load_native
    lib = load_native("datafeed")
    lib.datafeed_open.restype = ctypes.c_void_p
    lib.datafeed_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_int, ctypes.c_int]
    lib.datafeed_num_batches.restype = ctypes.c_int64
    lib.datafeed_num_batches.argtypes = [ctypes.c_void_p]
    lib.datafeed_num_tokens.restype = ctypes.c_int64
    lib.datafeed_num_tokens.argtypes = [ctypes.c_void_p]
    lib.datafeed_next.restype = ctypes.c_int
    lib.datafeed_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.datafeed_close.argtypes = [ctypes.c_void_p]
    return lib


class TokenFileDataset(IterableDataset):
    def __init__(self, path: str, seq_len: int, batch_size: int,
                 shuffle: bool = True, seed: int = 0, num_threads: int = 2,
                 queue_depth: int = 4, epochs: int = 1):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.path = path
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = num_threads
        self.queue_depth = queue_depth
        self.epochs = epochs
        self._lib = _lib()
        self._handle = self._lib.datafeed_open(
            path.encode(), seq_len, batch_size, int(shuffle), seed,
            num_threads, queue_depth)
        if not self._handle:
            raise ValueError(
                f"datafeed_open failed for {path} (too small for "
                f"seq_len={seq_len}, batch_size={batch_size}?)")

    @property
    def num_batches(self) -> int:
        return int(self._lib.datafeed_num_batches(self._handle))

    @property
    def num_tokens(self) -> int:
        return int(self._lib.datafeed_num_tokens(self._handle))

    def __iter__(self) -> Iterator[dict]:
        buf = np.empty((self.batch_size, self.seq_len + 1), np.int32)
        epoch = 0
        while epoch < self.epochs:
            rc = self._lib.datafeed_next(
                self._handle, buf.ctypes.data_as(ctypes.c_void_p))
            if rc < 0:
                raise RuntimeError("datafeed_next failed")
            yield {"input_ids": buf[:, :-1].copy(),
                   "labels": buf[:, 1:].copy()}
            if rc == 1:
                epoch += 1

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.datafeed_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
