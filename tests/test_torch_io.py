"""``io`` of the port against the JAX package's on the CPU: the datasets,
``random_split`` and the samplers give JAX's index lists (explicit numpy
generators, ``set_epoch``, explicit ``rank`` / ``num_replicas``,
``drop_last``); ``DataLoader`` batches are bitwise JAX's with
``num_workers=0`` (map-style and iterable, ``batch_size=None``, tuple
and dict collation); ``close()`` leaves no live thread; the native token
feed's batches are bitwise JAX's wrapper's on the same library, file and
seed, and a numpy rebuild of the windows (``chip_smoke.datafeed_windows``).
No test starts a worker pool: the pool's batches are held bitwise against
``num_workers=0`` on the card (``tests/test_torch_cuda.py``)."""

import ctypes
import threading

import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
from paddle_tpu.io import token_dataset as jtoken

import chip_smoke
import paddle_tpu_torch as tp
import paddle_tpu_torch.io as tio
from paddle_tpu_torch.io import token_dataset as ttoken
from paddle_tpu_torch.utils import cpp_extension

N = 11


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, 3)).astype(np.float32),
            rng.integers(0, 5, N))


def _same(a, b):
    """Bitwise equal, structure by structure."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


class _Pairs:
    def __init__(self, dicts=False):
        self.x, self.y = _data()
        self.dicts = dicts

    def __getitem__(self, i):
        if self.dicts:
            return {"x": self.x[i], "y": self.y[i], "n": i}
        return self.x[i], self.y[i]

    def __len__(self):
        return N


def _iterable(mod):
    class Stream(mod.IterableDataset):
        def __iter__(self):
            x, y = _data(1)
            for i in range(N):
                yield x[i], int(y[i])
    return Stream()


def _batches(loader):
    it = iter(loader)
    try:
        return list(it)
    finally:
        if hasattr(it, "close"):
            it.close()


LOADERS = [
    ("map-b4", lambda m: _Pairs(), dict(batch_size=4)),
    ("map-b4-drop_last", lambda m: _Pairs(), dict(batch_size=4,
                                                  drop_last=True)),
    ("map-dict", lambda m: _Pairs(dicts=True), dict(batch_size=3)),
    ("map-batch_size_none", lambda m: _Pairs(), dict(batch_size=None)),
    ("map-no_buffer", lambda m: _Pairs(), dict(batch_size=5,
                                               use_buffer_reader=False)),
    ("tensor_dataset", lambda m: m.TensorDataset(list(_data())),
     dict(batch_size=4)),
    ("iterable-b3", lambda m: _iterable(m), dict(batch_size=3)),
    ("iterable-b3-drop_last", lambda m: _iterable(m),
     dict(batch_size=3, drop_last=True)),
    ("iterable-batch_size_none", lambda m: _iterable(m),
     dict(batch_size=None)),
]


@pytest.mark.parametrize("case", LOADERS, ids=[c[0] for c in LOADERS])
def test_dataloader_batches_are_jaxs(case):
    _, make, kw = case
    j = _batches(jio.DataLoader(make(jio), **kw))
    t = _batches(tio.DataLoader(make(tio), **kw))
    assert len(j) == len(t) > 0
    for a, b in zip(j, t):
        _same(a, b)


def test_dataloader_with_a_batch_sampler_is_jaxs():
    def make(m):
        sampler = m.RandomSampler(list(range(N)),
                                  generator=np.random.default_rng(4))
        return m.DataLoader(_Pairs(), batch_sampler=m.BatchSampler(
            sampler=sampler, batch_size=3))
    j, t = _batches(make(jio)), _batches(make(tio))
    assert len(j) == len(t) == 4
    for a, b in zip(j, t):
        _same(a, b)


def test_collate_of_tensor_samples():
    batch = [(torch.arange(3), torch.ones(2, dtype=torch.bfloat16))] * 2
    ids, half = tio.default_collate_fn(batch)
    assert isinstance(ids, np.ndarray) and ids.shape == (2, 3)
    assert torch.is_tensor(half) and half.dtype == torch.bfloat16


def _live_prefetch():
    return [t for t in threading.enumerate()
            if t.name.startswith("paddle_tpu_torch-dataloader")]


def test_close_leaves_no_live_thread():
    it = iter(tio.DataLoader(_Pairs(), batch_size=1, prefetch_factor=1))
    next(it)
    assert _live_prefetch()
    it.close()
    assert not _live_prefetch()
    with iter(tio.DataLoader(_Pairs(), batch_size=2)) as it2:
        next(it2)
    assert not _live_prefetch()
    assert tio.get_worker_info() is None


SAMPLERS = [
    ("sequence", lambda m: list(m.SequenceSampler(list(range(7))))),
    ("random", lambda m: list(m.RandomSampler(
        list(range(9)), generator=np.random.default_rng(1)))),
    ("random-replacement", lambda m: list(m.RandomSampler(
        list(range(9)), replacement=True, num_samples=12,
        generator=np.random.default_rng(2)))),
    ("random-num_samples", lambda m: list(m.RandomSampler(
        list(range(9)), num_samples=4, generator=np.random.default_rng(3)))),
    ("batch", lambda m: list(m.BatchSampler(list(range(10)),
                                            batch_size=3))),
    ("batch-drop_last", lambda m: [len(m.BatchSampler(
        list(range(10)), batch_size=3, drop_last=True))] + list(
        m.BatchSampler(list(range(10)), batch_size=3, drop_last=True))),
]
for _r in range(3):
    for _drop in (False, True):
        for _epoch in (0, 2):
            SAMPLERS.append((
                f"distributed-rank{_r}-drop{int(_drop)}-epoch{_epoch}",
                lambda m, r=_r, d=_drop, e=_epoch: _dist(m, r, d, e)))


def _dist(m, rank, drop, epoch):
    s = m.DistributedBatchSampler(list(range(10)), batch_size=2,
                                  num_replicas=3, rank=rank, shuffle=True,
                                  drop_last=drop)
    s.set_epoch(epoch)
    return [len(s)] + list(s)


@pytest.mark.parametrize("case", SAMPLERS, ids=[c[0] for c in SAMPLERS])
def test_sampler_indices_are_jaxs(case):
    _, run = case
    assert run(tio) == run(jio)


def test_datasets_are_jaxs():
    x, y = _data()
    for m in (jio, tio):
        with pytest.raises(ValueError):
            m.TensorDataset([x, y[:3]])
    parts = [m.random_split(list(range(10)), [3, 4, 3],
                            generator=np.random.default_rng(0))
             for m in (jio, tio)]
    assert [p.indices for p in parts[0]] == [p.indices for p in parts[1]]
    assert [list(p) for p in parts[0]] == [list(p) for p in parts[1]]
    for m in (jio, tio):
        with pytest.raises(ValueError):
            m.random_split(list(range(10)), [3, 3])
    cat = [m.ConcatDataset([list(range(3)), list(range(10, 14))])
           for m in (jio, tio)]
    assert [c[i] for c in cat for i in (0, 4, -1)] == \
        [c[i] for c in cat[::-1] for i in (0, 4, -1)]
    assert len(cat[0]) == len(cat[1]) == 7
    sub = [m.Subset(list(range(20)), [5, 2, 9]) for m in (jio, tio)]
    assert [sub[0][i] for i in range(3)] == [sub[1][i] for i in range(3)]
    chain = [list(m.ChainDataset([_iterable(m), _iterable(m)]))
             for m in (jio, tio)]
    _same(chain[0], chain[1])
    with pytest.raises(TypeError):
        len(_iterable(tio))


def test_default_seeds_follow_the_port_seed():
    """Without a generator the samplers draw from the port's CPU
    generator: equal under one seed, new on the next pass."""
    runs = []
    for _ in range(2):
        tp.seed(11)
        s = tio.RandomSampler(list(range(50)))
        w = tio.WeightedRandomSampler([0.0, 1.0, 2.0, 3.0], 40)
        runs.append((list(s), list(s), list(w)))
    assert runs[0] == runs[1]
    assert runs[0][0] != runs[0][1]
    assert sorted(runs[0][0]) == list(range(50))
    assert 0 not in runs[0][2] and len(runs[0][2]) == 40


def test_distributed_sampler_defaults_to_one_replica():
    s = tio.DistributedBatchSampler(list(range(5)), batch_size=2)
    assert (s.num_replicas, s.rank) == (1, 0)
    assert list(s) == [[0, 1], [2, 3], [4]]


def test_io_names_are_jaxs():
    assert set(jio.__all__) == set(tio.__all__)
    assert all(hasattr(tio, n) for n in tio.__all__)


# -- the native token feed ----------------------------------------------------

@pytest.fixture
def token_file(tmp_path):
    toks = np.random.default_rng(0).integers(0, 50257, 9000).astype(
        np.int32)
    return toks, ttoken.write_token_file(str(tmp_path / "toks.bin"), toks)


@pytest.fixture
def feeds(monkeypatch):
    """Opened feeds, closed at the end (their C++ threads run until
    then).  JAX's wrapper runs on the port's build of the same source
    (its own library is a ``make`` of ``csrc/``, which this test does
    not start)."""
    cpp_extension.load_native("datafeed")           # built at first use
    target = str(cpp_extension.native_target("datafeed"))
    monkeypatch.setattr("paddle_tpu.utils.cpp_extension.load_native",
                        lambda name, **kw: ctypes.CDLL(target))
    opened = []

    def make(mod, *args, **kw):
        ds = mod.TokenFileDataset(*args, **kw)
        opened.append(ds)
        return ds
    yield make
    for ds in opened:
        ds.close()


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("epochs", [1, 2])
def test_token_feed_is_jaxs(token_file, feeds, shuffle, epochs):
    toks, path = token_file
    kw = dict(seq_len=63, batch_size=4, shuffle=shuffle, seed=5,
              epochs=epochs)
    j = list(feeds(jtoken, path, **kw))
    t = list(feeds(ttoken, path, **kw))
    ds = feeds(ttoken, path, **kw)
    assert ds.num_batches == 35 and ds.num_tokens == 9000
    assert len(j) == len(t) == 35 * epochs
    for a, b in zip(j, t):
        _same(a, b)
    for e in range(epochs):
        ref = chip_smoke.datafeed_windows(toks, 63, 4, 5, shuffle, 35, e)
        for got, w in zip(t[35 * e:35 * (e + 1)], ref):
            assert got["input_ids"].tobytes() == w[:, :-1].tobytes()
            assert got["labels"].tobytes() == w[:, 1:].tobytes()


def test_token_feed_through_the_loader(token_file, feeds):
    """The LM adapter of the hapi phase: (input_ids, labels) pairs, the
    loader carrying them unbatched."""
    toks, path = token_file
    ds = feeds(ttoken, path, seq_len=63, batch_size=4, seed=1)
    pairs = _batches(tio.DataLoader(chip_smoke.lm_pairs(ds),
                                    batch_size=None))
    ref = chip_smoke.datafeed_windows(toks, 63, 4, 1, True, 35)
    assert len(pairs) == 35
    for (ids, labels), w in zip(pairs, ref):
        assert ids.dtype == np.int32 and ids.tobytes() == \
            w[:, :-1].tobytes() and labels.tobytes() == w[:, 1:].tobytes()


def test_token_feed_refuses_a_short_file(tmp_path):
    path = ttoken.write_token_file(str(tmp_path / "t.bin"), np.arange(10))
    with pytest.raises(ValueError, match="datafeed_open failed"):
        ttoken.TokenFileDataset(path, seq_len=63, batch_size=4)
    with pytest.raises(FileNotFoundError):
        ttoken.TokenFileDataset(str(tmp_path / "none"), 8, 2)


def test_worker_arrays_through_shared_memory():
    """A worker's large arrays travel as shared-memory blocks (small ones
    and non-arrays as they are); the consumer's copy is bitwise and the
    block is gone after it, read or dropped."""
    import os

    from paddle_tpu_torch.io import dataloader as D
    big = np.arange(40000, dtype=np.float32).reshape(200, 200)
    batch = {"x": big, "y": np.arange(4), "n": [big.astype(np.int64), 3]}
    sent = D._to_shared(batch)
    assert isinstance(sent["x"], D._Shared) and \
        isinstance(sent["n"][0], D._Shared)
    assert sent["y"] is batch["y"] and sent["n"][1] == 3
    names = [sent["x"].name, sent["n"][0].name]
    assert all(os.path.exists(f"/dev/shm/{n}") for n in names)
    got = D._from_shared(sent)
    _same(got, batch)
    assert not any(os.path.exists(f"/dev/shm/{n}") for n in names)
    dropped = D._to_shared(big)
    assert D._from_shared(dropped, keep=False) is None
    assert not os.path.exists(f"/dev/shm/{dropped.name}")
