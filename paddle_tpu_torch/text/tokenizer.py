"""FasterTokenizer — native WordPiece tokenization
(``paddle_tpu/text/tokenizer.py``), ctypes over ``csrc/tokenizer``.

Reference parity: ``faster_tokenizer``
(paddle/fluid/operators/string/faster_tokenizer_op.cc — BERT tokenize as
a graph op) + the strings kernel family (phi/kernels/strings/).  As in
the JAX package, tokenization is host data-plane work: a native C++
WordPiece encoder feeding int ids into the input pipeline, not an
in-graph op.  The port builds the JAX package's source as it is, with
g++, into its own build directory (``utils/cpp_extension.load_native``),
and reads it only.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

__all__ = ["FasterTokenizer"]


def _lib():
    from paddle_tpu_torch.utils.cpp_extension import load_native
    lib = load_native("tokenizer", required_symbol="tok_encode")
    lib.tok_create.restype = ctypes.c_void_p
    lib.tok_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.tok_destroy.argtypes = [ctypes.c_void_p]
    lib.tok_id_count.restype = ctypes.c_int64
    lib.tok_id_count.argtypes = [ctypes.c_void_p]
    lib.tok_token_to_id.restype = ctypes.c_int64
    lib.tok_token_to_id.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.tok_encode.restype = ctypes.c_int64
    lib.tok_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_int64),
                               ctypes.c_int64]
    return lib


class FasterTokenizer:
    """BERT-style WordPiece tokenizer backed by the native encoder.

    vocab: path to a one-token-per-line vocab file, OR a {token: id} dict
    / list of tokens (written to a temp file for the native side — ids
    must then be dense 0..n-1).

    Case folding is ASCII-only (the native side uses the C locale):
    non-ASCII text passes through unfolded — matching vocab entries must
    be cased as they appear, unlike BERT's full-unicode BasicTokenizer.
    """

    def __init__(self, vocab: Union[str, Dict[str, int], Sequence[str]],
                 do_lower_case: bool = True,
                 cls_token: str = "[CLS]", sep_token: str = "[SEP]",
                 pad_token: str = "[PAD]"):
        self._lib = _lib()
        if self._lib is None:
            raise RuntimeError("native tokenizer library unavailable")
        self._own_path = None
        if not isinstance(vocab, str):
            if isinstance(vocab, dict):
                items = sorted(vocab.items(), key=lambda kv: kv[1])
                if [i for _, i in items] != list(range(len(items))):
                    raise ValueError("vocab dict ids must be dense 0..n-1")
                tokens = [t for t, _ in items]
            else:
                tokens = list(vocab)
            import tempfile
            fd, path = tempfile.mkstemp(suffix=".vocab")
            with os.fdopen(fd, "w") as f:
                f.write("\n".join(tokens))
            self._own_path = vocab = path
        self._h = self._lib.tok_create(vocab.encode(),
                                       1 if do_lower_case else 0)
        if not self._h:
            raise FileNotFoundError(f"cannot read vocab file {vocab}")
        self.vocab_size = int(self._lib.tok_id_count(self._h))
        self.cls_id = self.token_to_id(cls_token)
        self.sep_id = self.token_to_id(sep_token)
        if self.cls_id < 0 or self.sep_id < 0:
            import warnings
            missing = [t for t, i in ((cls_token, self.cls_id),
                                      (sep_token, self.sep_id)) if i < 0]
            warnings.warn(
                f"special token(s) {missing} not in the vocab; sequences "
                "will be encoded WITHOUT [CLS]/[SEP] markers", stacklevel=2)
        _pad = self.token_to_id(pad_token)
        if _pad < 0:
            import warnings
            warnings.warn(
                f"pad token {pad_token!r} is not in the vocab; padding "
                "will use id 0, which is a REAL vocab token — pass the "
                "correct pad_token for this vocab", stacklevel=2)
        self.pad_id = max(_pad, 0)

    def token_to_id(self, token: str) -> int:
        return int(self._lib.tok_token_to_id(self._h, token.encode()))

    def tokenize_ids(self, text: str, max_len: int = 512) -> List[int]:
        """Raw WordPiece ids, no special tokens."""
        buf = (ctypes.c_int64 * max_len)()
        n = self._lib.tok_encode(self._h, text.encode("utf-8", "ignore"),
                                 buf, max_len)
        return list(buf[:n])

    def __call__(self, text: Union[str, Sequence[str]],
                 max_seq_len: int = 128,
                 pad_to_max_seq_len: bool = True):
        """Encode text(s) → {'input_ids', 'token_type_ids'} int64 arrays
        with [CLS]/[SEP] added (the faster_tokenizer_op output contract)."""
        texts = [text] if isinstance(text, str) else list(text)
        add_specials = self.cls_id >= 0 and self.sep_id >= 0
        if add_specials and max_seq_len < 3:
            raise ValueError(f"max_seq_len={max_seq_len} leaves no room "
                             "for [CLS]/[SEP] plus content")
        rows = []
        for s in texts:
            ids = self.tokenize_ids(s, max_len=max_seq_len)
            if add_specials:
                ids = [self.cls_id] + ids[:max_seq_len - 2] + [self.sep_id]
            rows.append(ids)
        width = max_seq_len if pad_to_max_seq_len else \
            max(len(r) for r in rows)
        out = np.full((len(rows), width), self.pad_id, np.int64)
        for i, r in enumerate(rows):
            out[i, :len(r)] = r
        return {"input_ids": out,
                "token_type_ids": np.zeros_like(out)}

    def close(self):
        if getattr(self, "_h", None):
            self._lib.tok_destroy(self._h)
            self._h = None
        if self._own_path:
            try:
                os.remove(self._own_path)
            except OSError:
                pass
            self._own_path = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
