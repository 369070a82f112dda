"""The KV tier, parkable sessions and the handoff's transfer and wire
format against the JAX package on the CPU: the cases of
``tests/test_kv_tier.py`` (the tier manager's host and peer tiers,
faults, int8 payloads through the peer tier; park / resume, the
recompute fallback, auto-park, int8 pools, prefix demote / promote; the
router's replica-death migration and fleet park / resume), with greedy
tokens equal to the JAX single engine's; tier keys equal to JAX's; the
blocks' export / import (offsets, geometry checks, the fp <-> int8
boundary, bitwise with JAX's rule) and the wire bytes, equal in both
directions."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pp
from paddle_tpu.inference import kv_cache as JKV
from paddle_tpu.inference import kv_tier as JTIER
from paddle_tpu.inference.serving import \
    ContinuousBatchingEngine as JEngine
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM

from paddle_tpu_torch.inference import kv_cache as TKV
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        KVTierManager, ServingRouter,
                                        prefix_block_key, session_key)
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import LocalStore, default_registry
from paddle_tpu_torch.robustness import clear_faults, fault_stats, inject

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
ENGINE_KW = dict(slots=2, max_len=64, prefill_buckets=(32,),
                 paged_kv=True, kv_block_size=8, prefill_chunk=16)


@pytest.fixture(autouse=True)
def _clean_faults():
    clear_faults()
    yield
    clear_faults()


def _payload(seed=0, nblocks=2, dtype=np.float32):
    rng = np.random.default_rng(seed)
    kv = {"block_size": 8, "dtype": np.dtype(dtype).name,
          "k": [torch.from_numpy(rng.standard_normal((nblocks, 8, 2, 4))
                                 .astype(dtype)) for _ in range(2)],
          "v": [torch.from_numpy(rng.standard_normal((nblocks, 8, 2, 4))
                                 .astype(dtype)) for _ in range(2)]}
    return {"session": True, "block_size": 8, "pos": 14,
            "last_token": 42, "kv": kv}


def _assert_kv_equal(a, b):
    for part in ("k", "v"):
        assert len(a[part]) == len(b[part])
        for x, y in zip(a[part], b[part]):
            assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


# -- the tier manager ------------------------------------------------------------

def test_host_roundtrip():
    tier = KVTierManager()
    p = _payload()
    assert tier.spill("s1", p)
    assert tier.has("s1")
    st = tier.stats()
    assert st["host_entries"] == 1 and st["peer_entries"] == 0
    back = tier.fetch("s1")
    assert int(back["pos"]) == 14 and int(back["last_token"]) == 42
    _assert_kv_equal(back["kv"], p["kv"])


def test_write_through_and_peer_fetch_after_host_loss():
    tier = KVTierManager(store=LocalStore(), host_capacity_bytes=0)
    p = _payload(seed=1)
    assert tier.spill("s1", p)
    st = tier.stats()
    assert st["host_entries"] == 0 and st["peer_entries"] == 1
    _assert_kv_equal(tier.fetch("s1")["kv"], p["kv"])


def test_host_lru_eviction_bounded_by_capacity():
    tier = KVTierManager(store=LocalStore())
    a, b = _payload(seed=2), _payload(seed=3)
    assert tier.spill("a", a)
    tier.host_capacity_bytes = tier.stats()["host_bytes"] + 16
    assert tier.spill("b", b)
    st = tier.stats()
    assert st["host_entries"] == 1 and st["peer_entries"] == 2
    _assert_kv_equal(tier.fetch("a")["kv"], a["kv"])
    _assert_kv_equal(tier.fetch("b")["kv"], b["kv"])


def test_discard_and_corrupt_peer_part():
    tier = KVTierManager(store=LocalStore())
    tier.spill("s1", _payload())
    tier.discard("s1")
    assert not tier.has("s1") and tier.fetch("s1") is None
    assert tier.stats()["peer_entries"] == 0
    store = LocalStore()
    tier = KVTierManager(store=store, host_capacity_bytes=0)
    assert tier.spill("s1", _payload(seed=4))
    store.set("kvtier/s1/p0", b"\x00garbage\x00")
    assert tier.fetch("s1") is None


def test_spill_and_fetch_faults():
    tier = KVTierManager(store=LocalStore())
    inject("kv_tier.spill", times=1)
    assert tier.spill("s1", _payload()) is False
    assert not tier.has("s1")
    assert fault_stats("kv_tier.spill")["fires"] == 1
    assert tier.spill("s1", _payload(seed=5))
    inject("kv_tier.fetch", times=1)
    assert tier.fetch("s1") is None
    assert fault_stats("kv_tier.fetch")["fires"] == 1
    assert tier.fetch("s1") is not None


@pytest.mark.parametrize("tokens", [[1, 2, 3, 4], list(range(16)),
                                    [255] * 8])
def test_tier_keys_equal_jaxs(tokens):
    assert prefix_block_key(tokens) == JTIER.prefix_block_key(tokens)
    assert prefix_block_key(np.asarray(tokens, np.int64)) == \
        JTIER.prefix_block_key(tokens)
    assert session_key(7) == JTIER.session_key(7) == "sess/7"


def test_peer_blobs_equal_jaxs():
    """The same payload spilled through both packages' tiers leaves the
    same bytes in the peer store: the blob protocol and the wire format
    are JAX's."""
    rng = np.random.default_rng(6)
    a = rng.standard_normal((2, 8, 2, 4)).astype(np.float32)
    jstore, tstore = LocalStore(), LocalStore()
    JTIER.KVTierManager(store=jstore).spill(
        "s", {"pos": 3, "kv": {"block_size": 8, "k": [a], "v": [a]}})
    KVTierManager(store=tstore).spill(
        "s", {"pos": 3, "kv": {"block_size": 8, "k": [torch.from_numpy(a)],
                               "v": [torch.from_numpy(a)]}})
    assert tstore.get("kvtier/s/p0") == jstore.get("kvtier/s/p0")
    jm = __import__("json").loads(jstore.get("kvtier/s/meta"))
    tm = __import__("json").loads(tstore.get("kvtier/s/meta"))
    jm.pop("time"), tm.pop("time")
    assert tm == jm


# -- block transfer and the wire format ------------------------------------------

def _pools(quant=None, dtype="float32"):
    jp = JKV.PagedKVPool(2, 8, 8, 2, 4, getattr(jnp, dtype), quant=quant)
    tp = TKV.PagedKVPool(2, 8, 8, 2, 4, getattr(torch, dtype), "cpu",
                         quant=quant)
    return jp, tp


def _fp_export(seed=0, n=3):
    rng = np.random.default_rng(seed)
    return {"block_size": 8,
            "k": [rng.standard_normal((n, 8, 2, 4)).astype(np.float32)
                  for _ in range(2)],
            "v": [rng.standard_normal((n, 8, 2, 4)).astype(np.float32)
                  for _ in range(2)]}


def _as_torch(kv):
    return {k: [torch.from_numpy(np.asarray(a)) for a in v]
            if isinstance(v, list) else v for k, v in kv.items()}


def _equal_exports(t, j, parts=("k", "v")):
    for part in parts:
        for x, y in zip(t[part], j[part]):
            np.testing.assert_array_equal(
                torch.as_tensor(x).float().numpy(),
                np.asarray(y, np.float32))


@pytest.mark.parametrize("quant", [None, "int8"])
def test_export_import_match_jax(quant):
    """The same fp payload into both packages' pools (quantized at the
    boundary into int8 pools, bitwise JAX's rule), an import at an
    offset, then both exports: equal, scales too."""
    jp, tp = _pools(quant)
    seed = _fp_export()
    jp.import_blocks(seed, [4, 5, 6])
    tp.import_blocks(_as_torch(seed), [4, 5, 6])
    jp.import_blocks(seed, [1, 2], src_start=1)
    tp.import_blocks(_as_torch(seed), [1, 2], src_start=1)
    parts = ("k", "v", "k_scale", "v_scale") if quant else ("k", "v")
    j, t = jp.export_blocks([1, 2, 4, 5, 6]), tp.export_blocks([1, 2, 4, 5,
                                                              6])
    assert t["dtype"] == j["dtype"] and t["block_size"] == j["block_size"]
    _equal_exports(t, j, parts)
    assert set(t) == set(j)


def test_int8_payload_into_fp_pool_dequantizes_as_jax():
    jq, tq = _pools("int8")
    seed = _fp_export(1)
    jq.import_blocks(seed, [1, 2, 3])
    tq.import_blocks(_as_torch(seed), [1, 2, 3])
    jexp, texp = jq.export_blocks([1, 2, 3]), tq.export_blocks([1, 2, 3])
    jf, tf = _pools(None)
    jf.import_blocks(jexp, [5, 6, 7])
    tf.import_blocks(texp, [5, 6, 7])
    _equal_exports(tf.export_blocks([5, 6, 7]), jf.export_blocks([5, 6, 7]))


def test_transfer_checks_raise():
    _, tp = _pools("int8")
    _, tf = _pools(None)
    bad = {"block_size": 4, "k": [torch.zeros(1, 4, 2, 4)] * 2,
           "v": [torch.zeros(1, 4, 2, 4)] * 2}
    with pytest.raises(ValueError, match="geometry"):
        tf.import_blocks(bad, [1])
    with pytest.raises(ValueError, match="layers"):
        tf.import_blocks(dict(bad, k=bad["k"][:1]), [1])
    with pytest.raises(ValueError, match="exceeds payload"):
        tf.import_blocks(_as_torch(_fp_export()), [1, 2], src_start=2)
    scaleless = {"block_size": 8,
                 "k": [torch.zeros(1, 8, 2, 4, dtype=torch.int8)] * 2,
                 "v": [torch.zeros(1, 8, 2, 4, dtype=torch.int8)] * 2}
    with pytest.raises(ValueError, match="scaleless"):
        tp.import_blocks(scaleless, [1])
    tf.import_blocks(bad, [])                    # nothing to import


@pytest.mark.parametrize("dtype,quant", [("float32", None),
                                         ("bfloat16", None),
                                         ("float32", "int8"),
                                         ("bfloat16", "int8")])
def test_wire_bytes_equal_in_both_directions(dtype, quant):
    """A handoff of the same blocks: the port's bytes equal JAX's, JAX's
    deserialize in the port bitwise (bfloat16 as its 16-bit pattern) and
    the port's in JAX."""
    jp, tp = _pools(quant, dtype)
    seed = _fp_export(2)
    jp.import_blocks(seed, [1, 2, 3])
    tp.import_blocks(_as_torch(seed), [1, 2, 3])
    head = {"prompt": np.arange(20, dtype=np.int32), "tokens": 20,
            "first_token": 7, "block_size": 8, "first_token_at": 12.5,
            "route_s": 0.25}
    jb = JKV.serialize_handoff(dict(head, kv=jp.export_blocks([1, 2, 3])))
    tb = TKV.serialize_handoff(dict(head, kv=tp.export_blocks([1, 2, 3])))
    assert tb == jb
    back = TKV.deserialize_handoff(jb)
    for key in ("tokens", "first_token", "block_size", "first_token_at",
                "route_s"):
        assert back[key] == head[key]
    np.testing.assert_array_equal(back["prompt"], head["prompt"])
    exp = tp.export_blocks([1, 2, 3])
    for part in exp:
        if isinstance(exp[part], list):
            for x, y in zip(back["kv"][part], exp[part]):
                assert x.dtype == y.dtype and torch.equal(x, y)
    jback = JKV.deserialize_handoff(tb)
    assert str(jback["kv"]["k"][0].dtype) == str(jp.kpools[0].dtype)
    # and a pool fed from JAX's bytes exports the same blocks again
    _, tp2 = _pools(quant, dtype)
    tp2.import_blocks(back["kv"], [4, 5, 6])
    _equal_exports(tp2.export_blocks([4, 5, 6]), jp.export_blocks([1, 2, 3]),
                   ("k", "v", "k_scale", "v_scale") if quant else ("k", "v"))


def test_store_publish_fetch():
    store = LocalStore()
    payload = {"first_token": 3,
               "kv": {"block_size": 8, "k": [torch.ones(1, 8, 2, 16)],
                      "v": [torch.zeros(1, 8, 2, 16)]}}
    TKV.publish_handoff(store, "obs/handoff/r0", payload)
    assert TKV.fetch_handoff(store, "missing") is None
    got = TKV.fetch_handoff(store, "obs/handoff/r0")
    assert got["first_token"] == 3
    assert torch.equal(got["kv"]["k"][0], payload["kv"]["k"][0])
    assert JKV.fetch_handoff(store, "obs/handoff/r0")["first_token"] == 3


def test_int8_scales_bitwise_through_peer():
    _, tp = _pools("int8")
    tp.import_blocks(_as_torch(_fp_export(3, 2)), [1, 2])
    exp = tp.export_blocks([1, 2])
    tier = KVTierManager(store=LocalStore(), host_capacity_bytes=0)
    assert tier.spill("q", {"kv": exp, "block_size": 8})
    _, tp2 = _pools("int8")
    tp2.import_blocks(tier.fetch("q")["kv"], [3, 4])
    exp2 = tp2.export_blocks([3, 4])
    for part in ("k", "v", "k_scale", "v_scale"):
        for x, y in zip(exp[part], exp2[part]):
            assert torch.equal(x, y)


# -- sessions on the engine --------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    pp.seed(0)
    jm = JLlamaForCausalLM(JLlamaConfig.tiny(**TINY))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


PROMPTS = [np.arange(1 + i, 17 + i, dtype=np.int32) for i in range(4)]
_REFS = {}


def _reference(jm, i, **over):
    """The JAX single engine's tokens for PROMPTS[i], once."""
    key = (i, tuple(sorted(over.items())))
    if key not in _REFS:
        eng = JEngine(jm, **dict(ENGINE_KW, **over))
        r = eng.add_request(PROMPTS[i], max_new_tokens=8)
        _REFS[key] = [int(t) for t in eng.run()[r][1]]
        eng.close()
    return _REFS[key]


def _build(model, tier=None, **over):
    return ContinuousBatchingEngine(model, kv_tier=tier,
                                    **dict(ENGINE_KW, **over))


def _step_until_out(eng, rid, n):
    for _ in range(400):
        eng.step()
        slot = next((i for i, r in enumerate(eng._active)
                     if r is not None and r.rid == rid), None)
        if slot is not None and slot not in eng._prefilling \
                and len(eng._active[slot].out) >= n:
            return
    raise AssertionError("request never reached decode")


def test_park_resume_token_identity_and_timings(pair):
    jm, tm = pair
    tier = KVTierManager(store=LocalStore())
    eng = _build(tm, tier)
    rid = eng.add_request(PROMPTS[0], max_new_tokens=8)
    _step_until_out(eng, rid, 3)
    key = eng.park(rid)
    assert key is not None and tier.has(key)
    assert eng.parked_rids() == [rid]
    assert eng.pending == 0
    assert eng.park(rid) is None                 # no longer decoding
    eng.resume(rid)
    out = [int(t) for t in eng.run()[rid][1]]
    assert out == _reference(jm, 0)
    t = eng.request_status(rid).timings
    assert t["parked_s"] > 0 and t["resume_s"] >= 0
    assert t["decode_s"] >= 0 and t["ttft_s"] > 0
    with pytest.raises(KeyError):
        eng.resume(rid)
    eng.close()


def test_recompute_fallback_token_identity(pair):
    jm, tm = pair
    eng = _build(tm, KVTierManager())
    rid = eng.add_request(PROMPTS[0], max_new_tokens=8)
    _step_until_out(eng, rid, 3)
    eng.park(rid)
    inject("kv_tier.fetch", times=1)
    eng.resume(rid)
    clear_faults()
    res = eng.run()
    assert [int(t) for t in res[rid][1]] == _reference(jm, 0)
    assert np.array_equal(res[rid][0], PROMPTS[0])
    eng.close()


def test_auto_park_oversubscribed_slots(pair):
    jm, tm = pair
    eng = _build(tm, KVTierManager(), slots=1, auto_park_s=0.0)
    rids = [eng.add_request(p, max_new_tokens=8) for p in PROMPTS[:3]]
    out = eng.run()
    parks = default_registry().get("paddle_tpu_serving_session_parks_total")
    assert {k[0]: c.value() for k, c in parks.series()}.get("auto", 0) > 0
    for i, rid in enumerate(rids):
        assert [int(t) for t in out[rid][1]] == _reference(jm, i)
    eng.close()


def test_quant_kv_park_resume_bitwise(pair):
    jm, tm = pair
    eng = _build(tm, KVTierManager(store=LocalStore()), quant_kv="int8")
    ref = _build(tm, quant_kv="int8")
    r = ref.add_request(PROMPTS[0], max_new_tokens=8)
    ref_out = ref.run()[r][1]
    rid = eng.add_request(PROMPTS[0], max_new_tokens=8)
    _step_until_out(eng, rid, 3)
    assert eng.park(rid) is not None
    eng.resume(rid)
    assert eng.run()[rid][1] == ref_out
    assert ref_out == _reference(jm, 0, quant_kv="int8")
    eng.close()
    ref.close()


def test_prefix_demote_promote(pair):
    """Evicted prefix blocks demote to the tier and promote back at the
    next affine admission: the reuse counter shows the prefill skipped,
    and the tokens equal JAX's engine with no tier."""
    jm, tm = pair
    tier = KVTierManager()
    eng = _build(tm, tier, slots=1, num_kv_blocks=13)
    shared = np.arange(1, 25, dtype=np.int32)       # 3 full blocks
    p1 = np.concatenate([shared, [30, 31]]).astype(np.int32)
    p2 = np.concatenate([shared, [40, 41]]).astype(np.int32)
    eng.add_request(p1, max_new_tokens=6)
    eng.run()
    assert eng._prefix.evict(8) > 0
    assert tier.stats()["host_entries"] > 0
    r2 = eng.add_request(p2, max_new_tokens=6)
    out = eng.run()[r2][1]
    assert eng.request_status(r2).timings["prefix_tokens_reused"] >= 8
    je = JEngine(jm, **dict(ENGINE_KW, slots=1, num_kv_blocks=13))
    jr = je.add_request(p2, max_new_tokens=6)
    assert out == [int(t) for t in je.run()[jr][1]]
    eng.close()


def test_park_requires_tier_and_options_are_checked(pair):
    eng = _build(pair[1])
    with pytest.raises(ValueError, match="kv_tier"):
        eng.park(0)
    assert eng.checkpoint_sessions() == 0
    eng.close()
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatchingEngine(pair[1], slots=1, max_len=64,
                                 prefill_buckets=(16,), paged_kv=False,
                                 kv_tier=KVTierManager())
    with pytest.raises(ValueError, match="auto_park_s requires"):
        _build(pair[1], auto_park_s=1.0)


def test_parked_session_expires(pair):
    """A parked session keeps its deadline: past it, the next step
    retires it "timeout" and drops its tier payload."""
    import time
    tier = KVTierManager()
    eng = _build(pair[1], tier)
    rid = eng.add_request(PROMPTS[1], max_new_tokens=8, timeout_s=60.0)
    _step_until_out(eng, rid, 2)
    key = eng.park(rid)
    eng._parked[rid][0].deadline = time.perf_counter()   # now due
    eng.step()
    assert eng.request_status(rid) == "timeout"
    assert not tier.has(key) and eng.parked_rids() == []
    eng.close()


# -- the router: migration and fleet park / resume ----------------------------------

def _death_drill(pair, fault=None):
    jm, tm = pair
    rt = ServingRouter(tm, replicas=2, engine_kwargs=dict(ENGINE_KW),
                       kv_tier=KVTierManager(store=LocalStore()),
                       session_checkpoint_steps=1)
    rids = [rt.add_request(p, max_new_tokens=8) for p in PROMPTS]
    victim = None
    for _ in range(500):
        rt.step()
        for rep in rt._replicas.values():
            ready = [r for i, r in enumerate(rep.engine._active)
                     if r is not None and i not in rep.engine._prefilling
                     and len(r.out) >= 2]
            if not rep.dead and ready:
                victim = rep.id
                break
        if victim is not None:
            break
    assert victim is not None
    if fault:
        inject(fault, times=8)
    rt.kill_replica(victim)
    clear_faults()
    out = rt.run()
    for i, rid in enumerate(rids):
        assert [int(t) for t in out[rid][1]] == _reference(jm, i)
    return rt


def _requeues(reason):
    m = default_registry().get("paddle_tpu_router_requeues_total")
    return {k[0]: c.value() for k, c in m.series()}.get(reason, 0.0) \
        if m is not None else 0.0


def test_replica_death_migrates_sessions(pair):
    before = _requeues("session_migrate")
    _death_drill(pair)
    assert _requeues("session_migrate") > before


def test_migrate_fault_falls_back_to_prefill(pair):
    before = _requeues("session_migrate")
    _death_drill(pair, fault="session.migrate")
    assert _requeues("session_migrate") == before


def test_fleet_park_resume(pair):
    jm, tm = pair
    rt = ServingRouter(tm, replicas=2, engine_kwargs=dict(ENGINE_KW),
                       kv_tier=KVTierManager(store=LocalStore()))
    rids = [rt.add_request(p, max_new_tokens=8) for p in PROMPTS[:2]]
    parked = None
    for _ in range(500):
        rt.step()
        for rid in rids:
            freq = rt._requests[rid]
            if freq.phase != "decode":
                continue
            eng = rt._replicas[freq.replica].engine
            req = next((r for i, r in enumerate(eng._active)
                        if r is not None and r.rid == freq.engine_rid
                        and i not in eng._prefilling), None)
            if req is not None and len(req.out) >= 2 and rt.park(rid):
                parked = rid
                break
        if parked is not None:
            break
    assert parked is not None and parked in rt.parked_rids()
    rt.run()
    assert rt.resume(parked)
    out = rt.run()
    assert [int(t) for t in out[parked][1]] == \
        _reference(jm, rids.index(parked))
