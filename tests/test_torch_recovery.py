"""The port's fast recovery (``paddle_tpu_torch/robustness/recovery.py``)
against the JAX package's on the CPU: ``pack_state`` bytes both ways,
``params_digest``'s integer over mixed dtypes (and the plain digest in
chunks against the whole), the cases of ``tests/test_recovery.py``
(cadence, chunking, corrupt or truncated parts read as absent, ship and
fetch faults, peer first then disk, SDC vote, replay, quarantine and its
TTL, the roster read by either package), ``TrainStep(sdc_sentinel=...)``
and a restored tiny ``TrainStep`` whose next losses equal the
uninterrupted run's bit for bit (peer and disk paths, into a compiled
step).

What crosses between the packages: arrays (``pack_state`` blobs,
digests, the roster).  A whole ``TrainStep`` state crosses only within
the port: its ``rng_key`` is a torch generator state, which JAX's
threefry cannot continue (ROADMAP.md, queue 3)."""

import json

import ml_dtypes
import numpy as np
import pytest
import torch

import jax

from paddle_tpu import robustness as jrob
from paddle_tpu.observability.fleet import LocalStore as JLocalStore
from paddle_tpu.robustness import recovery as J

from paddle_tpu_torch import robustness as trob
from paddle_tpu_torch.distributed.checkpoint import AutoCheckpoint
from paddle_tpu_torch.distributed.elastic import free_port
from paddle_tpu_torch.distributed.tcp_store import TCPStore
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import default_registry
from paddle_tpu_torch.observability.fleet import LocalStore
from paddle_tpu_torch.ops.kernels import multi_tensor as MT
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.robustness import recovery as rec


@pytest.fixture(autouse=True)
def _clean_faults():
    trob.clear_faults()
    jrob.clear_faults()
    yield
    trob.clear_faults()
    jrob.clear_faults()


def _total(name, **labels):
    m = default_registry().get(name)
    if m is None:
        return 0.0
    return sum(child.value() for values, child in m.series()
               if all(dict(zip(m.labelnames, values)).get(k) == v
                      for k, v in labels.items()))


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": rng.standard_normal((16, 8)).astype(np.float32),
                   "b": rng.standard_normal((8,)).astype(np.float32)},
        "opt_state": {"w": {
            "m": rng.standard_normal((16, 8)).astype(np.float32),
            "v": rng.standard_normal((16, 8)).astype(np.float32)}},
        "step": 7,
    }


def _mixed(seed=0):
    """A tree of every leaf kind the digest takes."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((33, 5)).astype(np.float32)
    return {
        "f32": f, "bf16": f.astype(ml_dtypes.bfloat16),
        "fp8": f[:4].astype(ml_dtypes.float8_e4m3fn),
        "f16": f[:, 0].astype(np.float16),
        "i8": rng.integers(-128, 128, (17,)).astype(np.int8),
        "i32": rng.integers(-2 ** 31, 2 ** 31, (9,)).astype(np.int32),
        "f64": rng.standard_normal((6,)),
        "i64": rng.integers(-2 ** 40, 2 ** 40, (5,)),
        "c64": (f[:3, 0] + 1j * f[:3, 1]).astype(np.complex64),
        "bool": rng.random(11) > 0.5, "empty": np.zeros((0, 3), np.float32),
        "nested": [np.float32(1.5), {"z": np.int32(4), "a": None}],
    }


def _as_tensors(tree):
    """The same tree with torch tensors at the leaves (bf16 / fp8 as
    torch dtypes)."""
    from paddle_tpu_torch.nn.layer import _from_numpy
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_tensors(v) for v in tree]
    if tree is None:
        return None
    return _from_numpy(np.asarray(tree))


# -- the wire ---------------------------------------------------------------

def test_pack_state_bytes_equal_jax_both_ways():
    arrs = {"params": {"w": _mixed()["f32"], "h": _mixed()["bf16"],
                       "q": _mixed()["i8"]},
            "step": 3, "lr": [0.5, {"k": np.int32(2)}]}
    jb = J.pack_state(arrs, step=3, rank=1)
    tb = rec.pack_state(_as_tensors(arrs) | {"step": 3,
                                             "lr": [0.5, {"k": torch.tensor(
                                                 2, dtype=torch.int32)}]},
                        step=3, rank=1)
    assert jb == tb
    # port unpacks JAX's blob, JAX unpacks the port's: the same bits
    st, sc = rec.unpack_state(jb)
    assert sc == {"step": 3, "rank": 1}
    h = st["params"]["h"]
    assert torch.is_tensor(h) and h.dtype == torch.bfloat16
    assert h.view(torch.int16).numpy().tobytes() == \
        arrs["params"]["h"].tobytes()
    jst, _ = J.unpack_state(tb)
    np.testing.assert_array_equal(jst["params"]["w"], arrs["params"]["w"])
    assert jst["lr"][0] == 0.5 and jst["step"] == 3


def test_no_pickle_on_the_wire():
    blob = rec.pack_state(_state())
    assert b"\x80\x04" not in blob[:16]
    hlen = int.from_bytes(blob[:8], "big")
    assert json.loads(blob[8:8 + hlen])["version"] == 2


def test_checkpoint_flatten_roundtrip_and_names():
    st = _state(1)
    flat = rec.flatten_for_checkpoint(st)
    jflat = J.flatten_for_checkpoint(st)
    assert sorted(flat) == sorted(jflat)
    assert flat["__tree__"].tobytes() == jflat["__tree__"].tobytes()
    back = rec.unflatten_from_checkpoint(flat)
    np.testing.assert_array_equal(back["opt_state"]["w"]["v"],
                                  st["opt_state"]["w"]["v"])
    assert back["step"] == 7


# -- the digest -------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_params_digest_equals_jax(seed):
    tree = _mixed(seed)
    assert rec.params_digest(tree) == J.params_digest(tree)
    assert rec.params_digest(_as_tensors(tree)) == J.params_digest(tree)


def test_digest_leaf_order_is_jax_pytree_order():
    """Dict keys sorted, lists in order, None no leaf."""
    tree = {"b": np.ones(2, np.float32), "a": [np.zeros(3, np.int8), None,
                                               np.ones(1, np.float16)]}
    leaves = rec.digest_leaves(tree)
    ref = jax.tree.leaves(tree)
    assert [tuple(t.shape) for t in leaves] == [r.shape for r in ref]
    assert rec.params_digest({"x": np.arange(8, dtype=np.float32),
                              "y": np.arange(8, 16, dtype=np.float32)}) != \
        rec.params_digest({"x": np.arange(8, 16, dtype=np.float32),
                           "y": np.arange(8, dtype=np.float32)})


def test_plain_digest_in_chunks_equals_whole():
    leaves = rec.digest_leaves(_mixed(2))
    whole = MT.digest_reference(leaves, chunk=1 << 30)
    for chunk in (1, 7, 64):
        assert torch.equal(MT.digest_reference(leaves, chunk=chunk), whole)
    # the CPU wrapper is the plain version; the fold is the last value
    got = MT.multi_tensor_digest(leaves)
    assert torch.equal(got, whole)
    assert int(got[-1]) & 0xFFFFFFFF == MT.fnv_fold(
        [int(v) & 0xFFFFFFFF for v in got[:-1]])


def test_single_bit_flip_changes_the_digest_and_matches_jax():
    tree = _mixed(3)
    flipped = rec._flip_one_bit(tree)
    assert rec.params_digest(flipped) != rec.params_digest(tree)
    assert rec.params_digest(flipped) == J.params_digest(
        J._flip_one_bit(tree))
    diff = flipped["bf16"].view(torch.int16).numpy() ^ \
        tree["bf16"].view(np.int16)
    assert (diff != 0).sum() == 1


# -- peer snapshots -----------------------------------------------------------

def test_cadence_and_roundtrip():
    store = LocalStore()
    snap = rec.PeerSnapshotter(store, rank=0, world_size=2, interval_steps=5)
    state = _state()
    assert not snap.maybe_snapshot(3, state)
    assert snap.maybe_snapshot(5, state)
    step, out, meta = rec.restore_from_peers(store, 0)
    assert step == 5 and meta["rank"] == 0 and snap.last_step == 5
    np.testing.assert_array_equal(out["params"]["w"], state["params"]["w"])


def test_chunked_snapshot_over_a_tcp_store_reads_in_jax():
    """8 parts through the port's TCPStore (parallel bulk fetch); JAX's
    restore_from_peers reads the same keys."""
    s = TCPStore("127.0.0.1", free_port(), is_master=True, timeout=1.0)
    try:
        snap = rec.PeerSnapshotter(s, rank=1, world_size=3,
                                   interval_steps=1, chunk_bytes=256)
        state = _state(3)
        assert snap.snapshot(4, state)
        meta = json.loads(s.get("recovery/snap/1/meta").decode())
        assert meta["nparts"] > 1
        step, out, _ = rec.restore_from_peers(s, 1)
        assert step == 4
        np.testing.assert_array_equal(out["opt_state"]["w"]["m"],
                                      state["opt_state"]["w"]["m"])
        jstep, jout, _ = J.restore_from_peers(s, 1)
        assert jstep == 4
        np.testing.assert_array_equal(jout["params"]["b"],
                                      state["params"]["b"])
    finally:
        s.close()


@pytest.mark.parametrize("damage", ["corrupt", "truncate"])
def test_damaged_part_reads_as_absent(damage):
    store = LocalStore()
    rec.PeerSnapshotter(store, 0, 2, interval_steps=1).snapshot(2, _state())
    raw = bytearray(store.get("recovery/snap/0/p0"))
    if damage == "corrupt":
        raw[len(raw) // 2] ^= 0xFF
    else:
        raw = raw[:len(raw) // 2]
    store.set("recovery/snap/0/p0", bytes(raw))
    assert rec.restore_from_peers(store, 0) is None


def test_ship_fault_is_absorbed():
    store = LocalStore()
    snap = rec.PeerSnapshotter(store, 0, 2, interval_steps=1)
    before = _total("paddle_tpu_recovery_snapshot_errors_total")
    trob.inject("recovery.snapshot_ship", times=1)
    assert snap.snapshot(1, _state()) is False
    assert _total("paddle_tpu_recovery_snapshot_errors_total") == before + 1
    assert snap.snapshot(2, _state())
    assert rec.restore_from_peers(store, 0)[0] == 2


def test_buddy_mirror_and_reserve():
    store = LocalStore()
    s0 = rec.PeerSnapshotter(store, 0, 2, interval_steps=1)
    s1 = rec.PeerSnapshotter(store, 1, 2, interval_steps=1)
    s0.snapshot(3, _state(1))
    assert s1.buddy == 0 and s1.fetch_buddy() == 3
    store._kv = {k: v for k, v in store._kv.items()
                 if not k.startswith("recovery/snap/0")}
    assert rec.restore_from_peers(store, 0) is None
    s1.serve_held()
    step, out, _ = rec.restore_from_peers(store, 0)
    assert step == 3
    np.testing.assert_array_equal(out["params"]["w"],
                                  _state(1)["params"]["w"])
    assert rec.buddy_map(3) == J.buddy_map(3)
    with pytest.raises(ValueError):
        rec.buddy_of(0, 0)


@pytest.mark.parametrize("fault", [False, True])
def test_resume_peer_first_then_disk(tmp_path, fault):
    store = LocalStore()
    ck = AutoCheckpoint(str(tmp_path), save_interval_steps=1)
    ck.save_now(4, rec.flatten_for_checkpoint(_state(9)))
    rec.PeerSnapshotter(store, 0, 2, interval_steps=1).snapshot(6,
                                                                _state(6))
    path = "disk" if fault else "peer"
    before = _total("paddle_tpu_recovery_restores_total", path=path)
    if fault:
        trob.inject("recovery.peer_fetch", times=1)
    step, state, got = rec.resume_train_state(store, 0, auto_ckpt=ck,
                                              device="cpu")
    assert (step, got) == ((4, "disk") if fault else (6, "peer"))
    w = state["params"]["w"]
    w = w.numpy() if torch.is_tensor(w) else w
    np.testing.assert_array_equal(
        w, _state(9 if fault else 6)["params"]["w"])
    assert _total("paddle_tpu_recovery_restores_total",
                  path=path) == before + 1
    assert rec.resume_train_state(LocalStore(), 0) == (None, None, "none")


# -- SDC sentinels and the roster ---------------------------------------------

def _sentinels(store, n=3, **kw):
    return [rec.SDCSentinel(store, rank=r, dp_peers=list(range(n)),
                            host=f"h{r}", timeout=0.5, **kw)
            for r in range(n)]


def test_flip_detected_blamed_and_quarantined():
    store = LocalStore()
    sents = _sentinels(store)
    params = _state()["params"]
    sents[0].publish(10, params)
    trob.inject("train.sdc_flip", times=1)
    sents[1].publish(10, params)
    trob.clear_faults("train.sdc_flip")
    sents[2].publish(10, params)
    before = _total("paddle_tpu_sdc_detected_total", host="h1")
    v = sents[0].verify(10)
    assert not v["ok"] and v["blamed"] == [1] and v["quarantined"] == ["h1"]
    assert rec.is_quarantined(store, "h1") and not rec.is_quarantined(
        store, "h0")
    assert J.is_quarantined(store, "h1")      # JAX reads the port's roster
    assert _total("paddle_tpu_sdc_detected_total", host="h1") == before + 1


def test_two_replica_tie_blamed_via_replay():
    store = LocalStore()
    sents = _sentinels(store, n=2)
    params = _state()["params"]
    sents[0].publish(5, params)
    trob.inject("train.sdc_flip", times=1)
    sents[1].publish(5, params)
    trob.clear_faults("train.sdc_flip")
    v = sents[0].verify(5)
    assert not v["ok"] and v["blamed"] == [] and v["quarantined"] == []
    replayed = rec.deterministic_replay(_state(), lambda st: params)
    v = sents[0].verify(5, replay=lambda: replayed)
    assert v["replayed"] and v["blamed"] == [1]


def test_missing_peer_and_cadence():
    store = LocalStore()
    sents = _sentinels(store)
    params = _state()["params"]
    sents[0].publish(8, params)
    sents[1].publish(8, params)
    v = sents[0].verify(8, timeout=0.05)
    assert v["ok"] and v["missing"] == [2]
    s = rec.SDCSentinel(store, 0, [0], host="h", interval_steps=10)
    assert s.check(3, params) == {"checked": False, "ok": True}
    with pytest.raises(ValueError):
        rec.SDCSentinel(store, 0, [0], host="h", interval_steps=0)


def test_quarantine_roster_ttl_and_jax_keys(monkeypatch):
    store = JLocalStore()
    rec.quarantine_host(store, "hostA", reason="sdc@7")
    J.quarantine_host(store, "hostB")
    assert set(rec.quarantined_hosts(store)) == {"hostA", "hostB"}
    assert set(J.quarantined_hosts(store)) == {"hostA", "hostB"}
    rec.clear_quarantine(store, "hostA")
    assert set(J.quarantined_hosts(store)) == {"hostB"}
    monkeypatch.setenv("PADDLE_TPU_QUARANTINE_TTL_S", "60")
    rec_b = json.loads(store.get("recovery/quarantined/hostB").decode())
    rec_b["time"] -= 120
    store.set("recovery/quarantined/hostB", json.dumps(rec_b).encode())
    assert not rec.is_quarantined(store, "hostB")
    assert rec.probe_quarantine(store, "hostB")
    assert store.get("recovery/quarantined").decode() == ""
    rec.clear_quarantine(store)


def test_snapshotter_from_env(monkeypatch):
    assert rec.snapshotter_from_env() is None
    s = TCPStore("127.0.0.1", free_port(), is_master=True, timeout=1.0)
    try:
        monkeypatch.setenv("PADDLE_TPU_RECOVERY", "peer")
        monkeypatch.setenv("PADDLE_ELASTIC_STORE", f"127.0.0.1:{s.port}")
        monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
        snap = rec.snapshotter_from_env(interval_steps=2)
        assert (snap.rank, snap.buddy, snap.interval) == (1, 0, 2)
        assert snap.snapshot(2, _state())
        assert rec.restore_from_peers(s, 1)[0] == 2
        snap.store.close()
    finally:
        s.close()


# -- TrainStep ----------------------------------------------------------------

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)


def _step(seed=0, **kw):
    from paddle_tpu_torch import seed as tseed
    tseed(seed)
    m = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    return TrainStep(m, AdamW(learning_rate=1e-3, multi_precision=True),
                     **kw)


def _batch(i):
    ids = np.random.default_rng(100 + i).integers(0, 256, (2, 17))
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


def test_train_step_sdc_hook_cadence_and_divergence():
    store = LocalStore()
    sent = rec.SDCSentinel(store, 0, [0], host="h0", timeout=0.5)
    st = _step(sdc_sentinel=sent, sdc_check_interval=2)
    for i in range(4):
        st(_batch(i))
    assert store.check("sdc/2/0") and store.check("sdc/4/0")
    assert not store.check("sdc/1/0") and not store.check("sdc/3/0")
    assert st.last_sdc_verdict["ok"] and st.last_sdc_verdict["step"] == 4
    published = json.loads(store.get("sdc/4/0").decode())["digest"]
    assert published == rec.params_digest(st.params)
    # a peer whose digest cannot match
    store2 = LocalStore()
    sent2 = rec.SDCSentinel(store2, 0, [0, 1], host="h0", timeout=0.5,
                            quarantine=False)
    rec.SDCSentinel(store2, 1, [0, 1], host="h1").publish(
        1, {"w": np.full((3,), 7.0, np.float32)})
    st2 = _step(sdc_sentinel=sent2)
    st2(_batch(0))
    assert not st2.last_sdc_verdict["ok"]
    with pytest.raises(ValueError, match="sdc_check_interval"):
        _step(sdc_sentinel=sent, sdc_check_interval=0)


@pytest.mark.parametrize("path", ["peer", "disk"])
def test_restored_step_continues_bitwise(tmp_path, path):
    """Four steps with a snapshot and a checkpoint at step 2; a fresh,
    compiled step restored from either path runs steps 3 and 4 with the
    uninterrupted run's losses, bit for bit."""
    store = LocalStore()
    snap = rec.PeerSnapshotter(store, 0, 2, interval_steps=2)
    ck = AutoCheckpoint(str(tmp_path), save_interval_steps=2)
    ref = _step(0)
    losses = {}
    for i in range(1, 5):
        losses[i] = ref(_batch(i)).numpy().tobytes()
        if i == 2:
            sd = ref.state_dict()
            snap.maybe_snapshot(i, sd)
            pending = ck.maybe_save(i, rec.flatten_for_checkpoint(sd))
    pending.wait(timeout=30)
    fresh = _step(5)
    fresh.compile(_batch(3))
    if path == "disk":
        trob.inject("recovery.peer_fetch", times=1)
    step, state, got = rec.resume_train_state(store, 0, auto_ckpt=ck,
                                              device="cpu")
    assert (step, got) == (2, path)
    fresh.set_state_dict(state)
    assert fresh.step_count == 2
    for i in (3, 4):
        assert fresh(_batch(i)).numpy().tobytes() == losses[i], i
    assert rec.params_digest(fresh.params) == rec.params_digest(ref.params)
