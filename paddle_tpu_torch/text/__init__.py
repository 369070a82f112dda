"""The port's ``paddle_tpu.text`` (``paddle_tpu/text/__init__.py``):
text datasets, vocabulary utilities, ``viterbi_decode`` and the native
WordPiece ``FasterTokenizer`` (``text/tokenizer.py``).

Reference: python/paddle/text/datasets/ (Imdb imdb.py, Imikolov
imikolov.py, UCIHousing uci_housing.py, ...).  Every dataset either
reads user-supplied files (same simple formats) or generates the JAX
package's deterministic synthetic corpus (the same numpy draws, so the
same items) — enough for the hapi examples and pipeline tests to run
end to end without a download.
"""

from __future__ import annotations

import os
import re
from collections import Counter
from typing import Iterable, List, Optional

import numpy as np

from paddle_tpu_torch.io.dataset import Dataset

from paddle_tpu_torch.text.tokenizer import FasterTokenizer  # noqa: F401

__all__ = ["Vocab", "FasterTokenizer", "Imdb", "Imikolov", "UCIHousing",
           "LMDataset", "viterbi_decode"]


class Vocab:
    """Token <-> id mapping (reference paddlenlp-style Vocab used by the
    text datasets; built from a counter or token iterator)."""

    def __init__(self, counter=None, min_freq: int = 1,
                 unk_token: str = "<unk>", pad_token: str = "<pad>"):
        self._tok2id = {}
        self._id2tok = []
        for sp in (pad_token, unk_token):
            if sp is not None:
                self._add(sp)
        self.unk_token = unk_token
        self.pad_token = pad_token
        if counter:
            for tok, freq in sorted(counter.items(),
                                    key=lambda kv: (-kv[1], kv[0])):
                if freq >= min_freq:
                    self._add(tok)

    def _add(self, tok):
        if tok not in self._tok2id:
            self._tok2id[tok] = len(self._id2tok)
            self._id2tok.append(tok)

    @classmethod
    def build_vocab(cls, iterator: Iterable[List[str]], min_freq=1,
                    **kw) -> "Vocab":
        c = Counter()
        for toks in iterator:
            c.update(toks)
        return cls(c, min_freq=min_freq, **kw)

    def to_indices(self, tokens: List[str]) -> List[int]:
        unk = self._tok2id.get(self.unk_token, 0)
        return [self._tok2id.get(t, unk) for t in tokens]

    def to_tokens(self, ids) -> List[str]:
        return [self._id2tok[int(i)] for i in ids]

    def __len__(self):
        return len(self._id2tok)

    def __contains__(self, tok):
        return tok in self._tok2id


_WORDS = ("the a on in of to and tpu chip mesh shard pipe moe adam norm "
          "token train loss grad step model layer head expert ring flash "
          "scan fuse tile core lane sub hbm vmem ici link host data").split()


def _synthetic_sentences(n, seed, lo=5, hi=12):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(lo, hi))
        # zipf-flavored draws so vocab frequencies look natural
        idx = np.minimum(rng.zipf(1.3, k) - 1, len(_WORDS) - 1)
        out.append([_WORDS[j] for j in idx])
    return out


class Imdb(Dataset):
    """Sentiment-classification dataset (reference imdb.py): (token_ids,
    label).  Reads an on-disk ``data_file`` with `label<TAB>text` lines,
    else a deterministic synthetic corpus (label = parity of sentence
    content so a model can learn it)."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 cutoff: int = 1, seq_len: int = 16):
        self.seq_len = seq_len
        if data_file and os.path.exists(data_file):
            rows = []
            with open(data_file) as f:
                for ln in f:
                    lab, _, txt = ln.partition("\t")
                    rows.append((re.findall(r"\w+", txt.lower()),
                                 int(lab)))
            self._sents = [r[0] for r in rows]
            self._labels = [r[1] for r in rows]
        else:
            n = 800 if mode == "train" else 200
            self._sents = _synthetic_sentences(n, seed=5 if mode == "train"
                                               else 6)
            self._labels = [int(len(s) % 2) for s in self._sents]
        self.vocab = Vocab.build_vocab(self._sents, min_freq=cutoff)
        self.word_idx = self.vocab._tok2id  # reference attribute name

    def __len__(self):
        return len(self._sents)

    def __getitem__(self, idx):
        ids = self.vocab.to_indices(self._sents[idx])[:self.seq_len]
        pad = self.vocab._tok2id[self.vocab.pad_token]
        ids = ids + [pad] * (self.seq_len - len(ids))
        return np.asarray(ids, np.int64), np.int64(self._labels[idx])


class Imikolov(Dataset):
    """n-gram language-model dataset (reference imikolov.py): each item
    is an (n-1)-gram context plus the next word."""

    def __init__(self, data_file: Optional[str] = None, data_type="NGRAM",
                 window_size: int = 5, mode: str = "train", min_word_freq=1):
        if data_file and os.path.exists(data_file):
            with open(data_file) as f:
                sents = [re.findall(r"\w+", ln.lower()) for ln in f]
        else:
            sents = _synthetic_sentences(
                600 if mode == "train" else 150,
                seed=7 if mode == "train" else 8, lo=window_size + 1,
                hi=window_size + 8)
        self.vocab = Vocab.build_vocab(sents, min_freq=min_word_freq)
        self._grams = []
        for s in sents:
            ids = self.vocab.to_indices(s)
            for i in range(len(ids) - window_size + 1):
                self._grams.append(ids[i:i + window_size])

    def __len__(self):
        return len(self._grams)

    def __getitem__(self, idx):
        g = self._grams[idx]
        return np.asarray(g[:-1], np.int64), np.int64(g[-1])


class UCIHousing(Dataset):
    """Regression dataset (reference uci_housing.py): 13 features ->
    price.  Reads the standard whitespace-delimited file, else generates
    a fixed random linear-plus-noise problem."""

    FEATURES = 13

    def __init__(self, data_file: Optional[str] = None, mode: str = "train"):
        if data_file and os.path.exists(data_file):
            raw = np.loadtxt(data_file).astype(np.float32)
            x, y = raw[:, :-1], raw[:, -1:]
        else:
            rng = np.random.default_rng(9 if mode == "train" else 10)
            n = 400 if mode == "train" else 100
            x = rng.standard_normal((n, self.FEATURES)).astype(np.float32)
            w = np.linspace(-1, 1, self.FEATURES).astype(np.float32)
            y = (x @ w[:, None] + 0.05
                 * rng.standard_normal((n, 1))).astype(np.float32)
        # feature normalization, reference behavior
        mu, sd = x.mean(0, keepdims=True), x.std(0, keepdims=True) + 1e-6
        self._x = (x - mu) / sd
        self._y = y

    def __len__(self):
        return len(self._x)

    def __getitem__(self, idx):
        return self._x[idx], self._y[idx]


class LMDataset(Dataset):
    """Next-token LM dataset over a flat token stream: (input_ids,
    labels) windows of ``seq_len`` — the shape TrainStep consumes.  Built
    from a text file, a token array, or the synthetic corpus."""

    def __init__(self, tokens=None, data_file: Optional[str] = None,
                 seq_len: int = 32, vocab: Optional[Vocab] = None,
                 mode: str = "train"):
        self.seq_len = seq_len
        if tokens is not None:
            stream = np.asarray(tokens, np.int64)
            self.vocab = vocab
        else:
            if data_file and os.path.exists(data_file):
                with open(data_file) as f:
                    sents = [re.findall(r"\w+", ln.lower()) for ln in f]
            else:
                sents = _synthetic_sentences(
                    500 if mode == "train" else 100,
                    seed=11 if mode == "train" else 12)
            self.vocab = vocab or Vocab.build_vocab(sents)
            stream = np.asarray(
                [i for s in sents for i in self.vocab.to_indices(s)],
                np.int64)
        n = (len(stream) - 1) // seq_len
        self._x = stream[:n * seq_len].reshape(n, seq_len)
        self._y = stream[1:n * seq_len + 1].reshape(n, seq_len)

    def __len__(self):
        return len(self._x)

    def __getitem__(self, idx):
        return self._x[idx], self._y[idx]


def viterbi_decode(potentials, transition_params, lengths=None):
    """paddle.text.viterbi_decode parity: batched hard Viterbi over
    emission ``potentials`` [B, T, N] with ``transition_params`` [N, N].
    Returns (scores [B], paths [B, T] int64), on the potentials' device.
    ``lengths`` is accepted and not read, as in the JAX package (every
    row decodes all T steps).  Ties take the first index, as jnp.argmax
    does."""
    import torch

    pots = torch.as_tensor(potentials)
    trans = torch.as_tensor(transition_params).to(pots.device)
    score = pots[:, 0]                                  # [B, N]
    backs = []
    for t in range(1, pots.shape[1]):
        cand = score[:, :, None] + trans[None]          # [B, N, N]
        best, back = torch.max(cand, dim=1)             # [B, N] each
        score = best + pots[:, t]
        backs.append(back)
    scores, last = torch.max(score, dim=-1)             # [B]
    path = [last]
    for back in reversed(backs):
        # back belongs to step t+1 and yields path[t]
        path.append(torch.gather(back, 1, path[-1][:, None])[:, 0])
    paths = torch.stack(path[::-1], dim=1).to(torch.int64)
    return scores, paths
