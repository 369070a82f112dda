"""The port's observability and fault modules against the JAX package's
(``paddle_tpu.observability``, ``paddle_tpu.robustness.faults``, which
import no JAX): the same operations on both give the same exposition
text, registry snapshots, merged fleet snapshots and table, rule
verdicts, goodput and attainment, request attributions and fault-firing
sequences.  Plus the serving engine's metrics, spans and decisions on a
tiny model, the fleet store's raise, and the publish -> aggregate path
over a ``LocalStore``."""

import importlib
import json

import numpy as np
import pytest

PACKAGES = ("paddle_tpu", "paddle_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _fill(pkg, host=0):
    """One registry of every instrument kind, labelled and not, with
    lazy and pull gauges and an overflowing label set."""
    M = _mod(pkg, "observability.metrics")
    reg = M.MetricsRegistry()
    c = reg.counter("paddle_tpu_serving_requests_total", "requests")
    c.inc(3 + host)
    lab = reg.counter("paddle_tpu_serving_slo_total", "verdicts",
                      labelnames=("kind", "result"))
    lab.labels(kind="ttft", result="hit").inc(5 + host)
    lab.labels(kind="ttft", result="miss").inc(2)
    lab.labels(kind="tpot", result="hit").inc(4)
    g = reg.gauge("paddle_tpu_serving_queue_depth", "queue")
    g.set(7 - host)
    reg.gauge("paddle_tpu_serving_slots", "slots").set_function(lambda: 8)
    reg.gauge("paddle_tpu_serving_replica_role", "role",
              labelnames=("role",)).labels(
        role="decode" if host else "prefill").set(1)
    h = reg.histogram("paddle_tpu_serving_ttft_seconds", "ttft",
                      buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0, 0.07 * (host + 1)):
        h.observe(v)
    capped = reg.counter("paddle_tpu_capped_total", "cap", labelnames=("k",),
                         max_series=4)
    for i in range(7):
        capped.labels(k=str(i)).inc(i)
    return reg


@pytest.mark.parametrize("render", ["prometheus", "json", "collect"])
def test_exposition_and_snapshots_equal_jaxs(render):
    outs = []
    for pkg in PACKAGES:
        E = _mod(pkg, "observability.exposition")
        reg = _fill(pkg)
        if render == "prometheus":
            outs.append(E.render_prometheus(reg))
        elif render == "json":
            doc = json.loads(E.render_json(reg))
            doc.pop("time")                     # the wall clock
            outs.append(doc)
        else:
            outs.append(reg.collect())
    assert outs[0] == outs[1]
    if render == "prometheus":
        assert 'paddle_tpu_serving_ttft_seconds_bucket{le="0.1"} 3' in \
            outs[1]


def _snapshot(pkg, host):
    F = _mod(pkg, "observability.fleet")
    return {"schema": F.FLEET_SCHEMA, "host": f"h{host}", "time": 100.0,
            "seq": 1, "generation": 0, "restarts": 0,
            "metrics": _fill(pkg, host).collect()}


def test_merged_fleet_snapshots_equal_jaxs():
    outs = []
    for pkg in PACKAGES:
        F = _mod(pkg, "observability.fleet")
        merged, owned, conflicts = F.merge_snapshots(
            {f"h{i}": _snapshot(pkg, i) for i in range(3)})
        outs.append((merged.collect(), sorted(owned), conflicts))
    assert outs[0] == outs[1]


def test_fleet_table_equal_jaxs():
    tables = []
    for pkg in PACKAGES:
        F = _mod(pkg, "observability.fleet")
        agg = F.FleetAggregator()
        for i in range(2):
            agg.ingest(_snapshot(pkg, i))
        tables.append(agg.table())
    assert tables[0] == tables[1]
    assert "prefill" in tables[1] and "decode" in tables[1]


RULES = ("queue_saturation:threshold=5,consecutive=2;"
         "slo_attainment:kind=ttft,floor=0.9;"
         "slo_attainment:kind=tpot,floor=0.95")


def test_rule_verdicts_equal_jaxs():
    verdicts = []
    for pkg in PACKAGES:
        W = _mod(pkg, "observability.watchdog")
        M = _mod(pkg, "observability.metrics")
        rules = W.rules_from_spec(RULES)
        seen = []
        for step, (q, att) in enumerate([(9, 0.5), (9, 0.95), (2, 1.0),
                                         (6, float("nan")), (6, 0.2)]):
            reg = M.MetricsRegistry()
            reg.gauge("paddle_tpu_serving_queue_depth").set(q)
            reg.gauge("paddle_tpu_slo_attainment",
                      labelnames=("kind", "host")).labels(
                kind="ttft", host="r0").set(att)
            seen.append([r.evaluate(reg, float(step)) for r in rules])
        verdicts.append(([type(r).__name__ for r in rules], seen))
    assert verdicts[0] == verdicts[1]
    assert any(v for row in verdicts[1][1] for v in row)


def test_goodput_and_attainment_equal_jaxs():
    outs = []
    for pkg in PACKAGES:
        G = _mod(pkg, "observability.goodput")
        reg = _fill(pkg)
        reg.counter("paddle_tpu_train_productive_seconds_total").inc(30.0)
        reg.counter("paddle_tpu_elastic_downtime_seconds_total").inc(4.0)
        outs.append((G.compute_goodput(reg, wall_s=50.0),
                     G.slo_attainment(reg)))
    assert outs[0] == outs[1]


TIMINGS = [
    dict(queue_s=0.2, route_s=0.5, handoff_s=0.1, prefill_s=0.3,
         decode_s=1.2, ttft_s=1.1, total_s=2.4, generated=9.0),
    dict(queue_s=0.0, route_s=0.0, prefill_s=0.05, decode_s=0.4,
         ttft_s=0.06, total_s=0.5, generated=5.0, parked_s=3.0,
         resume_s=0.2),
]


def test_attribution_and_overage_equal_jaxs():
    outs = []
    for pkg in PACKAGES:
        FO = _mod(pkg, "observability.forensics")
        M = _mod(pkg, "observability.metrics")
        reg = M.MetricsRegistry()
        attributions = [FO.attribute(t) for t in TIMINGS]
        over = [FO.observe_retirement(t, targets={"ttft": 0.5,
                                                  "tpot": 0.1},
                                      registry=reg) for t in TIMINGS]
        outs.append((attributions,
                     [FO.dominant_cause(a) for a in attributions], over,
                     reg.collect()))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("spec", ["router.dispatch:p=0.5:n=2:times=5",
                                  "serving.kv_alloc:n=3,kv_tier.fetch:p=0.3",
                                  "serving.replica_kill:times=1"])
def test_fault_firing_sequences_equal_jaxs(spec):
    seqs = []
    for pkg in PACKAGES:
        FT = _mod(pkg, "robustness.faults")
        reg = FT.FaultRegistry(seed=11)
        reg.configure(spec)
        points = [s.point for s in reg.specs()]
        seq = [(p, reg.should_fire(p)) for _ in range(12) for p in points]
        seqs.append((seq, [reg.stats(p) for p in points]))
    assert seqs[0] == seqs[1]
    assert any(fired for _, fired in seqs[1][0])


def test_fault_point_raises_the_ports_injected_fault():
    from paddle_tpu_torch import robustness as R
    R.clear_faults()
    try:
        R.inject("serving.engine_step", times=1)
        with pytest.raises(R.InjectedFault):
            R.fault_point("serving.engine_step")
        R.fault_point("serving.engine_step")             # exhausted
        assert R.fault_stats("serving.engine_step") == {"calls": 2,
                                                        "fires": 1}
        with pytest.raises(ValueError, match="probability"):
            R.inject("x", probability=2.0)
    finally:
        R.clear_faults()
    assert issubclass(R.QueueFullError, RuntimeError)
    from paddle_tpu_torch.inference import serving
    assert serving.QueueFullError is R.QueueFullError


def test_flight_recorder_events_equal_jaxs():
    outs = []
    for pkg in PACKAGES:
        REC = _mod(pkg, "observability.recorder")
        rec = REC.FlightRecorder(capacity=4)
        for i in range(6):
            rec.record("serving.admit", rid=i, slot=i % 2)
        outs.append([{k: v for k, v in e.items() if k != "time"}
                     for e in rec.events()])
    assert outs[0] == outs[1] and len(outs[1]) == 4


def test_trace_export_shape_equal_jaxs():
    outs = []
    for pkg in PACKAGES:
        TR = _mod(pkg, "observability.tracing")
        tr = TR.Tracer(capacity=8, sample=1.0)
        root = tr.start_span("router.request", rid=1)
        child = tr.start_span("serving.request", parent=root, rid=1)
        tr.add_span("serving.decode_step", 1.0, 1.5, parent=child,
                    tokens=4)
        child.end()
        root.end()
        spans = tr.finished_spans()
        outs.append([(s["name"], s["parent_id"] is None,
                      s["trace_id"] == root.trace_id, s["attrs"])
                     for s in spans])
    assert outs[0] == outs[1]


def test_fleet_store_and_cli_raise_naming_item_8(capsys):
    """The fleet store is the ported TCPStore now: ``_connect_store``
    returns a client of it and the CLI renders the fleet table from it
    (the name stays from when both raised, naming item 8)."""
    from paddle_tpu_torch.distributed.elastic import free_port
    from paddle_tpu_torch.distributed.tcp_store import TCPStore
    from paddle_tpu_torch.observability import fleet as F
    server = TCPStore("127.0.0.1", free_port(), is_master=True, timeout=1.0)
    try:
        addr = f"127.0.0.1:{server.port}"
        client = F._connect_store(addr)
        server.set("obs/x", b"1")
        assert client.get("obs/x", wait=False) == b"1"
        client.close()
        assert F.main(["--store", addr]) == 0
        assert capsys.readouterr().out.strip()
    finally:
        server.close()


def test_publish_and_aggregate_over_a_local_store():
    from paddle_tpu_torch.observability import (FleetAggregator,
                                                LocalStore,
                                                MetricsPublisher)
    store = LocalStore()
    for i in range(2):
        MetricsPublisher(store, registry=_fill("paddle_tpu_torch", i),
                         host=f"h{i}", publish_goodput=False
                         ).publish_once()
    agg = FleetAggregator(store=store)
    assert sorted(agg.poll()) == ["h0", "h1"]
    merged = agg.merged_registry()
    assert merged.get("paddle_tpu_serving_requests_total").value() == 7.0


# -- the engine writes the serving metrics, spans and decisions -------------

def test_engine_metrics_spans_and_decisions():
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.observability import (decision_events,
                                                default_registry, tracer)
    from paddle_tpu_torch.observability.exposition import \
        render_prometheus
    model = LlamaForCausalLM(LlamaConfig.tiny(
        vocab_size=64, hidden_size=32, intermediate_size=64,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
        max_position_embeddings=64), device="cpu")
    reg = default_registry()

    def value(name, **labels):
        m = reg.get(name)
        if m is None:
            return 0.0
        return m.labels(**labels).value() if labels else m.value()
    before = {k: value(k) for k in (
        "paddle_tpu_serving_requests_total",
        "paddle_tpu_serving_retirements_total",
        "paddle_tpu_serving_prefill_chunks_total",
        "paddle_tpu_serving_tokens_total")}
    eng = ContinuousBatchingEngine(model, slots=2, max_len=48,
                                   prefill_buckets=(16,), paged_kv=True,
                                   kv_block_size=4, prefill_chunk=8)
    rng = np.random.default_rng(0)
    rids = [eng.add_request(rng.integers(0, 64, (n,)), max_new_tokens=3)
            for n in (5, 11)]
    eng.run()
    assert value("paddle_tpu_serving_requests_total") == \
        before["paddle_tpu_serving_requests_total"] + 2
    assert value("paddle_tpu_serving_retirements_total") == \
        before["paddle_tpu_serving_retirements_total"] + 2
    assert value("paddle_tpu_serving_prefill_chunks_total") == \
        before["paddle_tpu_serving_prefill_chunks_total"] + 3
    assert value("paddle_tpu_serving_tokens_total") == \
        before["paddle_tpu_serving_tokens_total"] + 6
    text = render_prometheus(reg)
    assert "paddle_tpu_serving_kv_blocks_free" in text
    assert 'paddle_tpu_serving_slo_total{kind="ttft"' in text
    st = eng.request_status(rids[0])
    assert st.trace_id is not None
    names = {s["name"] for s in tracer().finished_spans()
             if s["trace_id"] == st.trace_id}
    assert {"serving.request", "serving.prefill",
            "serving.decode_step"} <= names
    kinds = {(e.kind, e.rid) for e in decision_events()}
    assert ("admit", rids[1]) in kinds and ("retire", rids[1]) in kinds
