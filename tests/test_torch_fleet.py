"""The serving fleet against the JAX package on the CPU: the router in
every topology of ``tests/test_router.py`` (mixed, disaggregated with a
deeper decode tier, spec decode on the decode tier, an asymmetric fleet,
spill, the chaos fault points, elasticity, the watchdog rule, the
replica worker over a ``LocalStore``, fleets of mixed KV precision) and
the engine's fleet hooks.  Tiny fp32 Llama, weights copied from the JAX
model; greedy tokens must equal the JAX single engine's, and the JAX
router's where it runs beside."""

import numpy as np
import pytest

import paddle_tpu as pp
from paddle_tpu.inference.router import ServingRouter as JServingRouter
from paddle_tpu.inference.serving import \
    ContinuousBatchingEngine as JEngine
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM

from paddle_tpu_torch import robustness
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        ReplicaWorker, ServingRouter,
                                        SloAutoscaler, SloAutoscaleRule,
                                        fetch_result, submit_request)
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import LocalStore, default_registry
from paddle_tpu_torch.observability.metrics import MetricsRegistry

BS = 8
ENGINE_KW = dict(slots=2, max_len=64, prefill_buckets=(32,),
                 paged_kv=True, kv_block_size=BS, prefill_chunk=8)
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)


@pytest.fixture(scope="module")
def pair():
    pp.seed(0)
    jm = JLlamaForCausalLM(JLlamaConfig.tiny(**TINY))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def workload():
    rng = np.random.default_rng(7)
    shared = rng.integers(0, 256, (2 * BS,))      # two full shared blocks
    return [np.concatenate([shared, rng.integers(0, 256, (n,))])
            .astype(np.int32) for n in (3, 5, 7, 4, 6, 9)]


@pytest.fixture(scope="module")
def reference(pair, workload):
    """The JAX single paged engine's greedy tokens: the oracle every
    topology reproduces."""
    eng = JEngine(pair[0], **ENGINE_KW)
    rids = [eng.add_request(p, max_new_tokens=6) for p in workload]
    res = eng.run()
    eng.close()
    return [[int(t) for t in res[r][1]] for r in rids]


def _run(router, prompts, max_new=6):
    rids = [router.add_request(p, max_new_tokens=max_new)
            for p in prompts]
    res = router.run()
    return [[int(t) for t in res[r][1]] for r in rids], rids


def _series(name):
    m = default_registry().get(name)
    return {"/".join(k): c.value() for k, c in m.series()} \
        if m is not None else {}


def test_single_engine_matches_jax(pair, workload, reference):
    with ContinuousBatchingEngine(pair[1], **ENGINE_KW) as eng:
        rids = [eng.add_request(p, max_new_tokens=6) for p in workload]
        res = eng.run()
    assert [[int(t) for t in res[r][1]] for r in rids] == reference


# -- topologies ----------------------------------------------------------------

TOPOLOGIES = {
    "mixed": dict(replicas=2),
    "disaggregated": dict(replicas=2, prefill_replicas=1,
                          decode_kwargs=dict(steps_per_sync=4)),
}


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_router_matches_jaxs_router(pair, workload, reference, name):
    jm, tm = pair
    kw = dict(TOPOLOGIES[name], engine_kwargs=ENGINE_KW,
              warm_on_spawn=False)
    jr = JServingRouter(jm, **kw)
    jrids = [jr.add_request(p, max_new_tokens=6) for p in workload]
    jres = jr.run()
    jr.close()
    jtoks = [[int(t) for t in jres[r][1]] for r in jrids]
    got, rids = _run(ServingRouter(tm, **kw), workload)
    assert got == jtoks == reference


@pytest.mark.parametrize("kwargs", [
    dict(replicas=2, prefill_replicas=1,
         decode_kwargs=dict(spec_decode=3)),
    dict(replicas=2, prefill_replicas=1, prefill_kwargs=dict(slots=1),
         decode_kwargs=dict(slots=6, steps_per_sync=2)),
    dict(replicas=2, prefill_replicas=1, serialize_handoffs=False),
    dict(replicas=3, prefill_replicas=1),
], ids=["spec_decode", "asymmetric", "unserialized", "three"])
def test_disaggregated_topologies_match_jax(pair, workload, reference,
                                            kwargs):
    router = ServingRouter(pair[1], engine_kwargs=ENGINE_KW,
                           warm_on_spawn=False, **kwargs)
    got, rids = _run(router, workload)
    assert got == reference
    st = router.request_status(rids[-1])
    assert st == "ok"
    assert st.timings["handoff_s"] > 0 and st.timings["route_s"] > 0
    assert st.timings["attempts"] == 0.0
    router.close()


def test_disaggregated_handoffs_all_land(pair, workload, reference,
                                        monkeypatch):
    """Every request crosses by one handoff whose blocks the decode tier
    imports: none falls back or is requeued, and the blocks imported are
    those exported less the ones the decode tier's trie spared (the
    workload's shared prefix, routed affinely)."""
    from paddle_tpu_torch.inference.kv_cache import PagedKVPool
    blocks = {"export": 0, "import": 0}
    ex, im = PagedKVPool.export_blocks, PagedKVPool.import_blocks

    def export(pool, bids):
        out = ex(pool, bids)
        blocks["export"] += len(bids)
        return out

    def import_(pool, payload, dst, src_start=0):
        out = im(pool, payload, dst, src_start)
        blocks["import"] += len(dst)
        return out
    monkeypatch.setattr(PagedKVPool, "export_blocks", export)
    monkeypatch.setattr(PagedKVPool, "import_blocks", import_)
    names = ("handoffs", "requeues", "affinity")
    before = {n: _series(f"paddle_tpu_router_{n}_total") for n in names}
    router = ServingRouter(pair[1], replicas=2, prefill_replicas=1,
                           engine_kwargs=ENGINE_KW, warm_on_spawn=False)
    got, rids = _run(router, workload)
    router.close()
    assert got == reference
    delta = {n: {k: v - before[n].get(k, 0)
                 for k, v in _series(f"paddle_tpu_router_{n}_total").items()
                 if v != before[n].get(k, 0)} for n in names}
    assert delta["handoffs"] == {"ok": len(workload)}
    assert delta["requeues"] == {}
    assert delta["affinity"].get("affine", 0) > 0
    timings = [router.request_status(r).timings for r in rids]
    skipped = sum(t["prefix_tokens_reused"] for t in timings) // BS
    assert skipped > 0 and all(t["attempts"] == 0 for t in timings)
    assert 0 < blocks["import"] == blocks["export"] - skipped


def test_mixed_fleet_rides_affinity(pair, workload, reference):
    before = _series("paddle_tpu_router_affinity_total").get("affine", 0)
    got, _ = _run(ServingRouter(pair[1], replicas=2,
                                engine_kwargs=ENGINE_KW,
                                warm_on_spawn=False), workload)
    assert got == reference
    assert _series("paddle_tpu_router_affinity_total").get(
        "affine", 0) > before


def test_spill_when_affine_target_saturated(pair, workload, reference):
    before = _series("paddle_tpu_router_affinity_total").get("spill", 0)
    got, _ = _run(ServingRouter(pair[1], replicas=2,
                                engine_kwargs=ENGINE_KW, spill_threshold=1,
                                warm_on_spawn=False), workload)
    assert _series("paddle_tpu_router_affinity_total").get(
        "spill", 0) > before
    assert got == reference


def test_routing_key_ring_and_affinity_match_jax(pair):
    """The chain key, the sha1 vnode ring and the affinity trie with its
    cap decide as JAX's do, on stub engines."""
    def factory(role):
        class _Stub:
            slots = 2
            pending = 0

            def close(self):
                pass
        return _Stub()
    kw = dict(engine_factory=factory, replicas=3,
              engine_kwargs=dict(kv_block_size=BS), warm_on_spawn=False)
    jr, tr = JServingRouter(**kw), ServingRouter(**kw)
    rng = np.random.default_rng(5)
    for n in (3, BS, 2 * BS + 3, 5 * BS):
        p = rng.integers(0, 256, (n,)).astype(np.int32)
        assert tr._chain(p) == jr._chain(p)
        assert tr._ring_lookup(tr._chain(p)).id == \
            jr._ring_lookup(jr._chain(p)).id
    assert tr._ring == jr._ring
    for r in (jr, tr):
        r._affinity_cap = 8
        for i in range(30):
            r._register_chain(r._chain(np.arange(i, i + BS,
                                                 dtype=np.int32)), "m0")
    assert tr._trie_nodes == jr._trie_nodes <= 8


def test_warm_on_spawn_captures_every_replica(pair, workload, reference):
    """``warm_on_spawn=True`` runs ``aot_warmup`` on each replica (on the
    CPU: the programs bound to static buffers, no graph); the warmed
    fleet decodes through them."""
    router = ServingRouter(pair[1], replicas=2, prefill_replicas=1,
                           engine_kwargs=ENGINE_KW, warm_on_spawn=True)
    assert all(rep.engine._warmed for rep in router._replicas.values())
    got, _ = _run(router, workload)
    assert got == reference
    router.close()


def test_shared_model_refuses_tiers_of_other_weights(pair):
    with pytest.raises(ValueError, match="quant_weights"):
        ServingRouter(pair[1], replicas=2, prefill_replicas=1,
                      engine_kwargs=ENGINE_KW,
                      decode_kwargs=dict(quant_weights="int8"),
                      warm_on_spawn=False)
    assert getattr(pair[1], "_serving_quant_refs", 0) == 0


# -- chaos ---------------------------------------------------------------------

@pytest.fixture
def faults():
    robustness.clear_faults()
    yield robustness
    robustness.clear_faults()


def test_dispatch_fault_retries_to_completion(pair, workload, reference,
                                              faults):
    faults.inject("router.dispatch", times=2)
    got, _ = _run(ServingRouter(pair[1], replicas=2,
                                engine_kwargs=ENGINE_KW,
                                warm_on_spawn=False), workload)
    assert faults.fault_stats("router.dispatch")["fires"] == 2
    assert got == reference


def test_kv_transfer_fault_falls_back_to_fresh_prefill(
        pair, workload, reference, faults):
    before = _series("paddle_tpu_router_handoffs_total").get("fallback", 0)
    faults.inject("router.kv_transfer", times=1)
    got, _ = _run(ServingRouter(pair[1], replicas=2, prefill_replicas=1,
                                engine_kwargs=ENGINE_KW,
                                warm_on_spawn=False), workload)
    assert faults.fault_stats("router.kv_transfer")["fires"] == 1
    assert got == reference
    assert _series("paddle_tpu_router_handoffs_total").get(
        "fallback", 0) == before + 1


def test_replica_kill_fault_point_mid_run(pair, workload, reference,
                                          faults):
    faults.inject("serving.replica_kill", nth=5, times=1)
    router = ServingRouter(pair[1], replicas=2, engine_kwargs=ENGINE_KW,
                           warm_on_spawn=False)
    got, _ = _run(router, workload)
    assert faults.fault_stats("serving.replica_kill")["fires"] == 1
    assert len(router.replicas()) == 1
    assert got == reference


def test_kill_replica_api_mid_decode(pair, workload, reference):
    router = ServingRouter(pair[1], replicas=2, engine_kwargs=ENGINE_KW,
                           warm_on_spawn=False)
    rids = [router.add_request(p, max_new_tokens=6) for p in workload]
    for _ in range(6):
        router.step()
    victim = next(r for r, rep in router._replicas.items() if rep.assigned)
    router.kill_replica(victim)
    res = router.run()
    assert [[int(t) for t in res[r][1]] for r in rids] == reference


def test_engine_step_fault_requeues_through_the_router(
        pair, workload, reference, faults):
    """``serving.engine_step`` fails a replica's batch; the engine
    survives (its own containment) and the router re-queues the failed
    requests: every output still equals JAX's."""
    errors = default_registry().get(
        "paddle_tpu_serving_engine_errors_total")
    before = errors.value() if errors is not None else 0.0
    faults.inject("serving.engine_step", nth=12, times=1)
    router = ServingRouter(pair[1], replicas=2, engine_kwargs=ENGINE_KW,
                           warm_on_spawn=False)
    got, rids = _run(router, workload)
    assert faults.fault_stats("serving.engine_step")["fires"] == 1
    assert default_registry().get(
        "paddle_tpu_serving_engine_errors_total").value() == before + 1
    assert got == reference


def test_partition_probabilistic_dispatch_failures(pair, workload,
                                                   faults):
    faults.fault_registry()._rng.seed(5)
    faults.inject("router.dispatch", probability=0.5, times=4)
    got, _ = _run(ServingRouter(pair[1], replicas=2,
                                engine_kwargs=ENGINE_KW,
                                max_dispatch_retries=10,
                                warm_on_spawn=False), workload)
    assert all(len(o) == 6 for o in got)


def test_router_queue_bounded(pair):
    router = ServingRouter(pair[1], replicas=1, engine_kwargs=ENGINE_KW,
                           max_queue=2, warm_on_spawn=False)
    router.add_request(np.arange(8), max_new_tokens=2)
    router.add_request(np.arange(8), max_new_tokens=2)
    with pytest.raises(robustness.QueueFullError):
        router.add_request(np.arange(8), max_new_tokens=2)
    router.run()


# -- elasticity ------------------------------------------------------------------

def test_autoscaler_scales_up_on_queue_pressure(pair, workload):
    asc = SloAutoscaler(queue_high=2, cooldown_s=0.0, interval_s=0.0,
                        max_replicas=3)
    router = ServingRouter(pair[1], replicas=1, engine_kwargs=ENGINE_KW,
                           autoscaler=asc, warm_on_spawn=False)
    rids = [router.add_request(p, max_new_tokens=4) for p in workload]
    assert asc.evaluate_once() == "up"
    assert len(router.replicas()) == 2
    res = router.run()
    assert all(len(res[r][1]) == 4 for r in rids)


def test_autoscaler_attainment_breach_scales_up(pair):
    reg = MetricsRegistry()
    slo = reg.counter("paddle_tpu_serving_slo_total",
                      labelnames=("kind", "result"))
    asc = SloAutoscaler(registry=reg, ttft_floor=0.9, min_requests=4,
                        cooldown_s=0.0, interval_s=0.0, max_replicas=2)
    router = ServingRouter(pair[1], replicas=1, engine_kwargs=ENGINE_KW,
                           autoscaler=asc, warm_on_spawn=False)
    asc.evaluate_once(now=0.0)
    slo.labels(kind="ttft", result="hit").inc(2)
    slo.labels(kind="ttft", result="miss").inc(6)
    assert asc.evaluate_once(now=1.0) == "up"
    assert len(router.replicas()) == 2


def test_autoscaler_drains_when_idle_and_respects_min(pair):
    asc = SloAutoscaler(cooldown_s=0.0, interval_s=0.0, min_replicas=1)
    router = ServingRouter(pair[1], replicas=2, engine_kwargs=ENGINE_KW,
                           autoscaler=asc, warm_on_spawn=False)
    assert asc.evaluate_once(now=0.0) == "down"
    router.step()
    assert len(router.replicas()) == 1
    assert asc.evaluate_once(now=1.0) is None


def test_drain_finishes_in_flight_then_releases(pair, workload, reference):
    router = ServingRouter(pair[1], replicas=2, engine_kwargs=ENGINE_KW,
                           warm_on_spawn=False)
    rids = [router.add_request(p, max_new_tokens=6) for p in workload]
    for _ in range(3):
        router.step()
    victim = next(r for r, rep in router._replicas.items() if rep.assigned)
    assert router.drain(victim)
    res = router.run()
    assert [[int(t) for t in res[r][1]] for r in rids] == reference
    assert victim not in router.replicas()


def test_never_drains_last_decoder_and_cooldown(pair):
    router = ServingRouter(pair[1], replicas=2, prefill_replicas=1,
                           engine_kwargs=ENGINE_KW, warm_on_spawn=False)
    decoder = next(r for r, role in router.replicas().items()
                   if role == "decode")
    assert not router.drain(decoder)
    asc = SloAutoscaler(queue_high=1, cooldown_s=100.0, interval_s=0.0,
                        max_replicas=4)
    router = ServingRouter(pair[1], replicas=1, engine_kwargs=ENGINE_KW,
                           autoscaler=asc, warm_on_spawn=False)
    router.add_request(np.arange(8), max_new_tokens=2)
    router.add_request(np.arange(8), max_new_tokens=2)
    assert asc.evaluate_once(now=0.0) == "up"
    assert asc.evaluate_once(now=10.0) is None
    router.run()


def test_autoscale_rule_spawns_replica_on_breach(pair):
    router = ServingRouter(pair[1], replicas=1, engine_kwargs=ENGINE_KW,
                           warm_on_spawn=False)
    rule = SloAutoscaleRule(router, floor=0.9, max_replicas=2,
                            scale_cooldown_s=100.0)
    reg = MetricsRegistry()
    reg.gauge("paddle_tpu_slo_attainment", labelnames=("kind", "host")) \
        .labels(kind="ttft", host="r0").set(0.4)
    detail = rule.evaluate(reg, now=0.0)
    assert detail and "spawned replica" in detail
    assert len(router.replicas()) == 2
    detail = rule.evaluate(reg, now=1.0)
    assert detail and "spawned" not in detail


# -- the replica worker over a store -------------------------------------------

def test_mixed_worker_round_trip(pair, workload, reference):
    store = LocalStore()
    eng = ContinuousBatchingEngine(pair[1], **ENGINE_KW)
    w = ReplicaWorker(store, eng, role="mixed", worker_id="m0")
    assert store.check("serve/worker/m0")
    seqs = [submit_request(store, "m0", p, 6) for p in workload]
    for _ in range(600):
        if all(fetch_result(store, "m0", s) is not None for s in seqs):
            break
        w.poll()
    outs = [[int(t) for t in fetch_result(store, "m0", s)["tokens"]]
            for s in seqs]
    assert outs == reference
    assert all(fetch_result(store, "m0", s)["status"] == "ok"
               for s in seqs)
    eng.close()


def test_prefill_decode_pipeline_over_store(pair, workload, reference):
    store = LocalStore()
    pw = ReplicaWorker(store, ContinuousBatchingEngine(
        pair[1], role="prefill", **ENGINE_KW), role="prefill",
        worker_id="p0")
    dw = ReplicaWorker(store, ContinuousBatchingEngine(
        pair[1], role="decode", **ENGINE_KW), role="decode",
        worker_id="d0")
    s1 = submit_request(store, "p0", workload[0], 6)
    for _ in range(600):
        if fetch_result(store, "p0", s1) is not None:
            break
        pw.poll()
    handoff = fetch_result(store, "p0", s1)
    assert "kv" in handoff and "first_token" in handoff
    s2 = submit_request(store, "d0", workload[0], 6, handoff=handoff)
    for _ in range(600):
        if fetch_result(store, "d0", s2) is not None:
            break
        dw.poll()
    assert [int(t) for t in fetch_result(store, "d0", s2)["tokens"]] == \
        reference[0]
    pw.engine.close(), dw.engine.close()


def test_stop_key_exits_and_main_raises(pair):
    from paddle_tpu_torch.inference import router as R
    store = LocalStore()
    eng = ContinuousBatchingEngine(pair[1], **ENGINE_KW)
    w = ReplicaWorker(store, eng, role="mixed", worker_id="s0")
    store.set("serve/s0/stop", b"1")
    assert w.serve_forever(max_steps=50) == 0
    assert w.should_stop()
    eng.close()
    with pytest.raises(NotImplementedError, match="item 8"):
        R.main(["--store", "127.0.0.1:1"])


# -- mixed KV precision --------------------------------------------------------

@pytest.mark.parametrize("kwargs", [
    dict(decode_kwargs=dict(quant_kv="int8")),
    dict(prefill_kwargs=dict(quant_kv="int8")),
], ids=["fp_prefill_int8_decode", "int8_prefill_fp_decode"])
def test_mixed_quant_kv_fleet_works(pair, workload, reference, kwargs):
    """The handoff converts at the import boundary: every request
    completes; tokens agree with the fp engine as in JAX's test (at least
    80%: int8 KV flips near-ties)."""
    router = ServingRouter(pair[1], replicas=2, prefill_replicas=1,
                           engine_kwargs=ENGINE_KW, warm_on_spawn=False,
                           **kwargs)
    outs, rids = _run(router, workload)
    assert all(len(o) == 6 for o in outs)
    assert all(str(router.request_status(r)) == "ok" for r in rids)
    matched = sum(a == b for o, ref in zip(outs, reference)
                  for a, b in zip(o, ref))
    assert matched / sum(len(r) for r in reference) >= 0.8
    router.close()


def test_int8_fleet_handoff_stays_int8(pair, workload):
    """A fleet of int8 pools ships int8 payloads with their scales: at
    these fp32 shapes a block's K/V bytes are 5/16 of the fp fleet's
    (int8 values plus a 4-byte scale for every 16), under half with the
    JSON heads."""
    sizes = {}
    for name, kv in (("fp", None), ("int8", "int8")):
        before = _series("paddle_tpu_router_handoff_bytes_total").get("", 0)
        router = ServingRouter(pair[1], replicas=2, prefill_replicas=1,
                               engine_kwargs=dict(ENGINE_KW, quant_kv=kv),
                               warm_on_spawn=False)
        outs, _ = _run(router, workload)
        assert all(len(o) == 6 for o in outs)
        sizes[name] = _series("paddle_tpu_router_handoff_bytes_total") \
            .get("", 0) - before
        router.close()
    assert 0 < sizes["int8"] < sizes["fp"] / 2


# -- the engine's fleet hooks ----------------------------------------------------

def test_timings_always_carry_route_and_handoff(pair):
    eng = ContinuousBatchingEngine(pair[1], **ENGINE_KW)
    rid = eng.add_request(np.arange(9, dtype=np.int32), max_new_tokens=2)
    eng.run()
    t = eng.request_status(rid).timings
    assert t["route_s"] == 0.0 and t["handoff_s"] == 0.0
    assert t["parked_s"] == 0.0 and t["resume_s"] == 0.0


def test_engine_rejects_disagg_without_paged(pair):
    eng = ContinuousBatchingEngine(pair[1], slots=1, max_len=64,
                                   prefill_buckets=(16,), paged_kv=False)
    with pytest.raises(ValueError, match="paged"):
        eng.add_request(np.arange(8), max_new_tokens=2, prefill_only=True)
    with pytest.raises(ValueError, match="paged"):
        eng.add_request(np.arange(8), max_new_tokens=2,
                        handoff={"block_size": BS})
    paged = ContinuousBatchingEngine(pair[1], **ENGINE_KW)
    with pytest.raises(ValueError, match="two ends"):
        paged.add_request(np.arange(8), max_new_tokens=2,
                          prefill_only=True, handoff={"block_size": BS})
    with pytest.raises(ValueError, match="block_size"):
        paged.add_request(np.arange(8), max_new_tokens=2,
                          handoff={"block_size": 4})
    with pytest.raises(ValueError, match="role"):
        ContinuousBatchingEngine(pair[1], role="router", **ENGINE_KW)


def test_engine_publishes_role_gauge(pair):
    ContinuousBatchingEngine(pair[1], slots=1, max_len=64,
                             prefill_buckets=(16,), role="prefill")
    m = default_registry().get("paddle_tpu_serving_replica_role")
    assert {k[0]: c.value() for k, c in m.series()}.get("prefill") == 1.0


def test_prefill_only_then_handoff_matches_jax(pair, workload, reference):
    """The two ends of a handoff on two engines, as the router drives
    them: ``prefill_only`` retires "prefilled" with the first token, the
    exported blocks admit on the decode engine at ``pos = Lp``, and the
    decode engine's own prefix trie spares the blocks it holds (the
    second request imports its tail only)."""
    tm = pair[1]
    pre = ContinuousBatchingEngine(tm, role="prefill", **ENGINE_KW)
    dec = ContinuousBatchingEngine(tm, role="decode", **ENGINE_KW)
    outs = []
    for i, p in enumerate(workload[:2]):
        r = pre.add_request(p, max_new_tokens=6, prefill_only=True)
        pre.run()
        assert pre.request_status(r) == "prefilled"
        h = pre.export_handoff(r)
        assert h["first_token"] == reference[i][0] and h["tokens"] == len(p)
        d = dec.add_request(p, max_new_tokens=6, handoff=h)
        outs.append([int(t) for t in dec.run()[d][1]])
        assert dec.request_status(d).timings["prefix_tokens_reused"] == \
            (0 if i == 0 else 2 * BS)
    assert outs == reference[:2]
    # the prefill engine released the handed-off blocks (the trie keeps
    # the prompt's full ones)
    assert pre._allocator.used_blocks == len(pre._prefix)
    r = pre.add_request(workload[2], max_new_tokens=6, prefill_only=True)
    pre.run()
    pre.discard_handoff(r)
    pre.discard_handoff(r)                      # tolerated
    assert pre._allocator.used_blocks == len(pre._prefix)
