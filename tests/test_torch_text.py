"""``text`` of the port against the JAX package's on the CPU: the
WordPiece ``FasterTokenizer`` (both wrappers over one build of
``csrc/tokenizer/tokenizer.cpp``: the port's g++ build, which JAX's
wrapper is pointed at instead of running its ``make``) gives the same
ids bit for bit on a synthetic vocab; ``Vocab``, the seeded datasets'
items and ``viterbi_decode`` (scores within 1e-6 relative, paths equal)
are JAX's."""

import ctypes

import numpy as np
import pytest
import torch

import paddle_tpu as pp
from paddle_tpu import text as jtext

import paddle_tpu_torch as tp
from paddle_tpu_torch import text
from paddle_tpu_torch.utils import cpp_extension


@pytest.fixture(autouse=True)
def _cpu_default():
    tp.set_device("cpu")
    yield
    from paddle_tpu_torch.core import state
    state.set_default_device("cuda")


VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
         + [f"##{c}" for c in "abcdefghijklmnopqrstuvwxyz0123456789"]
         + list("abcdefghijklmnopqrstuvwxyz,.!?")
         + [f"w{i}" for i in range(300)]
         + ["the", "quick", "brown", "fox", "jump", "##ed", "un",
            "##believ", "##able"])


@pytest.fixture
def tokenizers(monkeypatch):
    """(JAX's, the port's) tokenizer over VOCAB, closed at the end."""
    cpp_extension.load_native("tokenizer")          # built at first use
    target = str(cpp_extension.native_target("tokenizer"))
    monkeypatch.setattr("paddle_tpu.utils.cpp_extension.load_native",
                        lambda name, **kw: ctypes.CDLL(target))
    pair = (jtext.FasterTokenizer(VOCAB), text.FasterTokenizer(VOCAB))
    yield pair
    for t in pair:
        t.close()


def _texts(n, seed):
    rng = np.random.default_rng(seed)
    words = ["the", "Quick", "brown", "FOX", "jumps", "jumped",
             "unbelievable", "zzz", "w12", "w7xy", "w299q", "hello,world",
             "end.", "wow!", "x" * 120, "naïve"]
    return [" ".join(rng.choice(words, rng.integers(1, 40)))
            for _ in range(n)]


def test_token_ids_are_jaxs(tokenizers):
    jt, tt = tokenizers
    assert tt.vocab_size == jt.vocab_size == len(VOCAB)
    assert (tt.cls_id, tt.sep_id, tt.pad_id) == (jt.cls_id, jt.sep_id,
                                                  jt.pad_id)
    for s in _texts(50, 0):
        assert tt.tokenize_ids(s) == jt.tokenize_ids(s), s
    for tok in ("w12", "##s", "absent", "[CLS]"):
        assert tt.token_to_id(tok) == jt.token_to_id(tok)


@pytest.mark.parametrize("max_seq_len,pad", [(16, True), (64, True),
                                             (32, False)])
def test_batch_encoding_is_jaxs(tokenizers, max_seq_len, pad):
    jt, tt = tokenizers
    texts = _texts(8, max_seq_len)
    want = jt(texts, max_seq_len=max_seq_len, pad_to_max_seq_len=pad)
    got = tt(texts, max_seq_len=max_seq_len, pad_to_max_seq_len=pad)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int64
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(tt("w1 w2")["input_ids"],
                                  jt("w1 w2")["input_ids"])


def test_tokenizer_refusals():
    with pytest.raises(ValueError, match="dense"):
        text.FasterTokenizer({"a": 0, "b": 2})
    with pytest.warns(UserWarning, match="pad token"):
        tok = text.FasterTokenizer(["[CLS]", "[SEP]", "a"])
    with pytest.raises(ValueError, match="max_seq_len"):
        tok("a", max_seq_len=2)
    tok.close()


def test_vocab_is_jaxs():
    sents = [["a", "b", "a"], ["c", "a", "b"], ["d"]]
    jv = jtext.Vocab.build_vocab(sents, min_freq=1)
    tv = text.Vocab.build_vocab(sents, min_freq=1)
    assert tv._id2tok == jv._id2tok and len(tv) == len(jv)
    toks = ["a", "zz", "d", "<pad>"]
    assert tv.to_indices(toks) == jv.to_indices(toks)
    assert tv.to_tokens([0, 2, 4]) == jv.to_tokens([0, 2, 4])
    assert ("a" in tv) and ("zz" not in tv)
    v2 = text.Vocab.build_vocab(sents, min_freq=2)
    assert v2._id2tok == jtext.Vocab.build_vocab(sents, min_freq=2)._id2tok


@pytest.mark.parametrize("name,kw", [
    ("Imdb", {}), ("Imdb", {"mode": "test", "seq_len": 8}),
    ("Imikolov", {}), ("Imikolov", {"window_size": 3, "mode": "test"}),
    ("UCIHousing", {}), ("UCIHousing", {"mode": "test"}),
    ("LMDataset", {"seq_len": 16}),
])
def test_datasets_are_jaxs(name, kw):
    jd, td = getattr(jtext, name)(**kw), getattr(text, name)(**kw)
    assert len(td) == len(jd)
    for i in (0, 1, len(jd) // 2, len(jd) - 1):
        for a, b in zip(td[i], jd[i]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            assert np.asarray(a).dtype == np.asarray(b).dtype


def test_lm_dataset_from_tokens_is_jaxs():
    toks = np.arange(100)
    jd = jtext.LMDataset(tokens=toks, seq_len=9)
    td = text.LMDataset(tokens=toks, seq_len=9)
    assert len(td) == len(jd) == 11
    for i in range(len(td)):
        for a, b in zip(td[i], jd[i]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("B,T,N", [(1, 1, 3), (2, 5, 4), (3, 9, 6)])
def test_viterbi_decode_is_jaxs(B, T, N):
    rng = np.random.default_rng(B * 100 + T)
    pots = rng.standard_normal((B, T, N)).astype(np.float32)
    trans = rng.standard_normal((N, N)).astype(np.float32)
    js, jpath = jtext.viterbi_decode(pp.to_tensor(pots), pp.to_tensor(trans))
    ts, tpath = text.viterbi_decode(torch.from_numpy(pots),
                                    torch.from_numpy(trans))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js.numpy()),
                               rtol=1e-6, atol=1e-6)
    assert tpath.dtype == torch.int64
    np.testing.assert_array_equal(tpath.numpy(), np.asarray(jpath.numpy()))
    # the path's score under the model is the reported score
    for b in range(B):
        p = tpath[b].numpy()
        score = pots[b, 0, p[0]] + sum(trans[p[t - 1], p[t]] + pots[b, t, p[t]]
                                       for t in range(1, T))
        np.testing.assert_allclose(ts[b].item(), score, rtol=1e-5)


def test_top_level_names():
    assert tp.text is text and tp.static.nn.fc is not None
    assert tp.jit.to_static is not None
    assert set(jtext.__all__) == set(text.__all__)
