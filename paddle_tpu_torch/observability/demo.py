"""End-to-end observability demo (``python -m
paddle_tpu_torch.observability.demo``; ``paddle_tpu/observability/
demo.py``).

Runs a real workload on a tiny Llama (hidden 256, two heads of 128, one
kv head: widths the CUDA kernels take) — a few ``TrainStep`` updates,
the device profiler over the step's segments, and a 4-slot
continuous-batching serving loop — on the card by default (where there
is none it raises; ``--device cpu`` runs it on the CPU), then:

1. starts the ``/metrics`` endpoint and fetches it over HTTP (urllib
   against 127.0.0.1), printing the Prometheus text to stdout;
2. injects an exception inside a flight-recorder-instrumented loop and
   shows ``dump()`` producing the run's last structured events;
3. exports the trace (``--trace-out``) as Perfetto/chrome JSON and
   checks it holds a train + serve timeline with >= 3 nesting levels
   whose trace ids also appear in flight-recorder events, and device
   segments nested under ``train.step``;
4. arms the SLO watchdog with a step-time drift rule, forces a step-time
   regression, and shows exactly one ``slo_breach``.

``--fleet`` adds the fleet federation phase (publish -> aggregate ->
render in-process, a straggler breach, a merged multi-host trace);
``--forensics`` the request-forensics phase (every scheduler decision
kind, a rigged slow request explained by its dominant cause).

Exit code 0 only when every expected artifact is present.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import urllib.request


def _model(dev):
    """The demo's tiny Llama on `dev`: 2 layers, hidden 256, two heads of
    128 over one kv head (head_dim 128 and widths of 128: shapes every
    CUDA kernel takes)."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.tiny(vocab_size=256, hidden_size=256,
                           intermediate_size=512, num_hidden_layers=2,
                           num_attention_heads=2, num_key_value_heads=1,
                           max_position_embeddings=256)
    return LlamaForCausalLM(cfg, device=dev)


def _span_depth(span, by_id):
    d, p = 1, span["args"].get("parent_id")
    while p and p in by_id:
        d += 1
        p = by_id[p]["args"].get("parent_id")
    return d


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--port", type=int, default=0,
                    help="metrics port (0 = ephemeral)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--train-steps", type=int, default=3)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="where the model runs: cuda (default) or cpu")
    ap.add_argument("--trace-out", default=os.path.join(
        tempfile.gettempdir(), "paddle_tpu_torch_trace.json"),
                    help="Perfetto/chrome-trace export path")
    ap.add_argument("--fleet", action="store_true",
                    help="exercise the fleet federation phase "
                         "(publish -> aggregate -> render, in-process)")
    ap.add_argument("--fleet-trace-out", default=os.path.join(
        tempfile.gettempdir(), "paddle_tpu_torch_fleet_trace.json"),
                    help="merged multi-host Perfetto export path "
                         "(--fleet)")
    ap.add_argument("--forensics", action="store_true",
                    help="exercise the request-forensics phase: every "
                         "decision kind + a rigged slow request's "
                         "explain() table")
    args = ap.parse_args(argv)

    # head-based sampling must be on before the first instrument builds
    # the process tracer (CI exports a full trace; operators lower it)
    os.environ.setdefault("PADDLE_TPU_TRACE_SAMPLE", "1.0")

    import numpy as np

    import paddle_tpu_torch as pp
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.observability import (Watchdog, default_registry,
                                                flight_recorder,
                                                start_metrics_server, tracer)
    from paddle_tpu_torch.observability.watchdog import StepTimeDriftRule
    from paddle_tpu_torch.optimizer import SGD

    pp.seed(0)
    dev = pp.resolve_device(args.device)
    model = _model(dev)

    # -- train: populates the step-latency histogram + loss/grad gauges
    step = TrainStep(model, SGD(learning_rate=1e-2), accum_steps=2)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256, (2, 128)).astype(np.int64)
    # batches arrive device-resident one step ahead (device_prefetch),
    # populating the prefetch gauge/counter alongside the train metrics
    from paddle_tpu_torch.io import device_prefetch
    for batch in device_prefetch(
            ({"input_ids": ids, "labels": ids}
             for _ in range(args.train_steps)), depth=2, device=dev):
        loss = step(batch)
    print(f"[demo] trained {args.train_steps} steps, "
          f"loss={float(loss):.4f}", file=sys.stderr)

    # -- device profiler: decompose the step into op groups, time them,
    # and join against the cost model's roofline — the ranked attribution
    # table is the fusion target list
    from paddle_tpu_torch.observability.device_profiler import (
        DeviceProfiler, device_memory_monitor, llama_step_segments)
    prof = DeviceProfiler(device=dev)
    for seg in llama_step_segments(model, {"input_ids": ids,
                                           "labels": ids}):
        prof.add(seg)
    attribution = prof.profile(reps=2, warmup=1,
                               parent_span="train.step")
    print(attribution.table(), file=sys.stderr)
    rows = attribution.ranked()
    if attribution.skipped or len(rows) < 5 or not all(
            r.device_s > 0 and r.predicted_s > 0 and r.gap > 0
            for r in rows):
        print(f"[demo] FAIL: attribution table incomplete "
              f"({len(rows)} rows)", file=sys.stderr)
        return 1
    mem = device_memory_monitor()
    live = mem.sample(device=dev)
    census = mem.census(top=3, device=dev)
    print(f"[demo] device memory: {live} live bytes "
          f"(watermark {mem.watermark}); census top: "
          + ", ".join(f"{r['dtype']}{r['shape']}x{r['count']}"
                      for r in census), file=sys.stderr)
    if live <= 0 or not census:
        print("[demo] FAIL: live-buffer census empty", file=sys.stderr)
        return 1

    # -- serve: 4-slot continuous batching populates the serving counters
    with ContinuousBatchingEngine(model, slots=args.slots, max_len=64,
                                  prefill_buckets=(16, 32)) as eng:
        rids = [eng.add_request(rng.integers(0, 256, (5 + 3 * i,)),
                                max_new_tokens=8)
                for i in range(args.requests)]
        results = eng.run()
    print(f"[demo] served {len(results)} requests", file=sys.stderr)
    # retired requests self-describe their lifecycle
    st = eng.request_status(rids[0])
    if st != "ok" or not st.timings.get("first_token") or not st.trace_id:
        print(f"[demo] FAIL: request_status timings missing: {st} "
              f"{getattr(st, 'timings', None)}", file=sys.stderr)
        return 1
    print(f"[demo] request {rids[0]}: status={st} "
          f"ttft={st.timings['ttft_s'] * 1e3:.1f}ms "
          f"total={st.timings['total_s'] * 1e3:.1f}ms "
          f"trace={st.trace_id}", file=sys.stderr)

    # -- flight recorder: inject a mid-loop crash, show the post-mortem
    recorder = flight_recorder()
    try:
        for i in range(10):
            with recorder.instrumented("demo.loop", iteration=i):
                recorder.record("demo.tick", iteration=i)
                if i == 7:
                    raise RuntimeError("injected mid-loop failure")
    except RuntimeError:
        pass  # dump() already auto-fired to stderr
    events = recorder.events(last=5)
    print(f"[demo] flight recorder retained {len(recorder)} events; "
          f"last kinds: {[e['kind'] for e in events]}", file=sys.stderr)

    # -- tracing: export the stitched train+serve timeline
    trace = tracer().export_chrome(args.trace_out)
    spans = {e["args"]["span_id"]: e for e in trace["traceEvents"]
             if e.get("ph") == "X" and e.get("args", {}).get("span_id")}
    names = {e["name"] for e in spans.values()}
    depth = max(_span_depth(e, spans) for e in spans.values())
    trace_ids = {e["args"]["trace_id"] for e in spans.values()}
    stamped = [e for e in recorder.snapshot()
               if e.get("trace_id") in trace_ids]
    print(f"[demo] trace: {len(spans)} spans, max nesting {depth}, "
          f"{len(stamped)} flight-recorder events stamped with trace "
          f"ids -> {args.trace_out}", file=sys.stderr)
    if not {"train.step", "train.dispatch",
            "serving.request", "serving.prefill",
            "serving.decode_step", "compile.lower", "compile.xla"} <= names:
        print(f"[demo] FAIL: expected spans missing from {sorted(names)}",
              file=sys.stderr)
        return 1
    if depth < 3 or not stamped:
        print(f"[demo] FAIL: nesting depth {depth} < 3 or no stamped "
              "recorder events", file=sys.stderr)
        return 1
    # device segments must nest under a train.step span — host and
    # device time in ONE Perfetto view is the tentpole acceptance
    def _ancestors(e):
        out, p = [], e["args"].get("parent_id")
        while p and p in spans:
            out.append(spans[p]["name"])
            p = spans[p]["args"].get("parent_id")
        return out
    dev_spans = [e for e in spans.values()
                 if e["name"].startswith("device.")]
    nested = [e for e in dev_spans if "train.step" in _ancestors(e)]
    print(f"[demo] {len(dev_spans)} device segments in trace, "
          f"{len(nested)} nested under train.step", file=sys.stderr)
    if len(nested) < 5:
        print("[demo] FAIL: device segments not nested under train.step",
              file=sys.stderr)
        return 1

    # -- watchdog: baseline from the real steps, then a forced step-time
    # regression must trip the drift rule (alert + dumps)
    wd = Watchdog(rules=[StepTimeDriftRule(factor=1.5, min_samples=1)],
                  cooldown=0.0)
    wd.evaluate_once()                      # interval 1: seeds baseline
    hist = default_registry().get("paddle_tpu_train_step_seconds")
    slow = 10.0 * hist.sum() / max(1.0, hist.count())
    for _ in range(3):
        hist.observe(slow)                  # the forced regression
    alerts = wd.evaluate_once()
    breaches = [e for e in recorder.snapshot()
                if e["kind"] == "slo_breach"]
    print(f"[demo] watchdog: {len(alerts)} alert(s), "
          f"{len(breaches)} slo_breach event(s): "
          f"{alerts[0].detail if alerts else '-'}", file=sys.stderr)
    if len(alerts) != 1 or len(breaches) != 1:
        print("[demo] FAIL: expected exactly one slo_breach",
              file=sys.stderr)
        return 1

    # -- exposition: serve /metrics and fetch it over real HTTP
    server = start_metrics_server(port=args.port,
                                  registry=default_registry())
    print(f"[demo] metrics endpoint: {server.url}", file=sys.stderr)
    with urllib.request.urlopen(server.url, timeout=10) as resp:
        text = resp.read().decode()
    print(text)
    server.close()

    expected = ("paddle_tpu_train_step_seconds_bucket{le=",
                "paddle_tpu_train_loss",
                "paddle_tpu_serving_tokens_total",
                "paddle_tpu_serving_ttft_seconds_bucket{le=",
                "paddle_tpu_serving_decode_token_seconds_bucket{le=",
                "paddle_tpu_serving_prefill_bucket_total",
                "paddle_tpu_compile_total",
                "paddle_tpu_xla_flops",
                "paddle_tpu_device_live_bytes",
                "paddle_tpu_device_segment_seconds_bucket{",
                'paddle_tpu_slo_breaches_total{rule="step_time_drift"} 1')
    missing = [name for name in expected if name not in text]
    if missing:
        print(f"[demo] FAIL: missing series {missing}", file=sys.stderr)
        return 1
    if not any(e["kind"] == "crash" for e in recorder.snapshot()):
        print("[demo] FAIL: crash event not recorded", file=sys.stderr)
        return 1

    # -- fleet federation: publish -> aggregate -> render, in-process:
    # this process is host demo0; two synthetic hosts (one a
    # deliberate straggler) join it through a LocalStore, and the
    # aggregator must serve summed counters, host-labeled gauges, the
    # fleet table, a straggler breach, and a merged multi-host trace
    if args.fleet:
        rc = _fleet_phase(args)
        if rc:
            return rc

    # -- request forensics: every scheduler decision kind
    # exercised at least once, then one rigged slow request explained
    # with its dominant cause named
    if args.forensics:
        rc = _forensics_phase(args)
        if rc:
            return rc

    print("[demo] OK", file=sys.stderr)
    return 0


def _fleet_phase(args) -> int:
    import numpy as np

    from paddle_tpu_torch.observability import (Watchdog, default_registry,
                                                goodput_monitor,
                                                render_prometheus, tracer)
    from paddle_tpu_torch.observability.fleet import (FleetAggregator,
                                                      LocalStore,
                                                      MetricsPublisher)
    from paddle_tpu_torch.observability.metrics import MetricsRegistry
    from paddle_tpu_torch.observability.tracing import Tracer
    from paddle_tpu_torch.observability.watchdog import StragglerRule

    store = LocalStore()
    # host demo0: the REAL registry + tracer this demo already filled
    goodput_monitor().publish()
    MetricsPublisher(store, host="demo0", interval=999,
                     publish_goodput=True).publish_once()
    my_steps = default_registry().get(
        "paddle_tpu_train_steps_total").value()

    # hosts demo1/demo2: synthetic replicas running the same program —
    # same series names, their own values, scaled off THIS process's
    # real step EMA (a few CPU steps carry the compile spike); demo2 is
    # the deliberate straggler at 3x while demo0/demo1 sit near the
    # median
    my_ema = float(default_registry().get(
        "paddle_tpu_train_step_ema_seconds").value())
    rng = np.random.default_rng(0)
    for host, step_ms in (("demo1", my_ema * 1.05e3),
                          ("demo2", my_ema * 3e3)):
        reg = MetricsRegistry()
        reg.counter("paddle_tpu_train_steps_total",
                    "train steps executed").inc(my_steps)
        h = reg.histogram("paddle_tpu_train_step_seconds", "")
        for _ in range(int(my_steps) or 3):
            h.observe(step_ms / 1e3 * rng.uniform(0.9, 1.1))
        reg.gauge("paddle_tpu_train_step_ema_seconds",
                  "").set(step_ms / 1e3)
        reg.gauge("paddle_tpu_goodput", "").set(0.9)
        tr = Tracer(capacity=128, sample=1.0)
        # join the synthetic host's spans to THIS process's trace ids
        # (the elastic-generation stitching pattern: remote children
        # parent under a context extracted from the store)
        from paddle_tpu_torch.observability.tracing import SpanContext
        last = tracer().finished_spans(name="train.step", last=1)
        parent = SpanContext(last[0]["trace_id"], last[0]["span_id"],
                             True) if last else None
        with tr.span("train.step", parent=parent, replica=host):
            pass
        MetricsPublisher(store, registry=reg, tracer_=tr, host=host,
                         interval=999,
                         publish_goodput=False).publish_once()

    agg = FleetAggregator(store=store, stale_after=60.0)
    text = render_prometheus(agg)
    steps_m = agg.merged_registry(refresh=False).get(
        "paddle_tpu_train_steps_total")
    total_steps = sum(c.value() for _, c in steps_m.series())
    if total_steps != 3 * my_steps:
        print(f"[demo] FAIL: fleet steps {total_steps} != 3x "
              f"{my_steps}", file=sys.stderr)
        return 1
    if 'paddle_tpu_train_step_ema_seconds{host="demo2"}' not in text \
            or 'paddle_tpu_goodput' not in text:
        print("[demo] FAIL: host-labeled gauges missing from fleet "
              "exposition", file=sys.stderr)
        return 1
    print(f"[demo] fleet /metrics: counters summed across 3 hosts "
          f"({int(total_steps)} steps), gauges host-labeled",
          file=sys.stderr)
    print("[demo] fleet table:\n" + agg.table(), file=sys.stderr)

    # straggler rule against the merged registry: demo2 must breach
    wd = Watchdog(rules=[StragglerRule(factor=1.75)],
                  registry=agg.merged_registry(refresh=False),
                  cooldown=0.0)
    alerts = wd.evaluate_once()
    if len(alerts) != 1 or "demo2" not in alerts[0].detail:
        print(f"[demo] FAIL: straggler rule did not single out demo2: "
              f"{[a.detail for a in alerts]}", file=sys.stderr)
        return 1
    print(f"[demo] straggler breach: {alerts[0].detail}",
          file=sys.stderr)

    trace = agg.export_chrome(args.fleet_trace_out)
    tracks = [e for e in trace["traceEvents"]
              if e.get("name") == "process_name"]
    xs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    if len(tracks) < 3 or not xs:
        print(f"[demo] FAIL: merged trace has {len(tracks)} host "
              f"tracks / {len(xs)} spans", file=sys.stderr)
        return 1
    print(f"[demo] fleet trace: {len(xs)} spans across {len(tracks)} "
          f"host tracks -> {args.fleet_trace_out}", file=sys.stderr)
    return 0


def _forensics_phase(args) -> int:
    import time

    import numpy as np

    import paddle_tpu_torch as pp
    from paddle_tpu_torch.inference.kv_tier import KVTierManager
    from paddle_tpu_torch.inference.router import (ServingRouter,
                                                   SloAutoscaler)
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.observability import flight_recorder, forensics
    from paddle_tpu_torch.observability.fleet import LocalStore
    from paddle_tpu_torch.observability.forensics import (DECISION_KINDS,
                                                          decision_events)
    from paddle_tpu_torch.robustness import clear_faults, inject

    # the earlier phases filled the ring with their own serving events
    # (and their engine rids collide with this phase's); start clean so
    # the explain below joins exactly this drill's decisions
    flight_recorder().clear()
    clear_faults()

    pp.seed(0)
    model = _model(pp.resolve_device(args.device))
    kw = dict(slots=2, max_len=64, prefill_buckets=(32,),
              paged_kv=True, kv_block_size=8, prefill_chunk=16)

    # -- engine-side kinds: admit (defer + slot), park, resume, tier,
    # retire, expire — plus the RIGGED SLOW REQUEST: KV-alloc
    # exhaustion starves its admission, so queue_wait must come out as
    # its dominant cause
    eng = ContinuousBatchingEngine(
        model, kv_tier=KVTierManager(store=LocalStore()), **kw)
    slow = eng.add_request(np.arange(1, 17, dtype=np.int32),
                           max_new_tokens=4)
    inject("serving.kv_alloc", times=5000)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.25:
        eng.step()
    clear_faults()
    eng.run()
    exp = forensics.explain(slow, status=eng.request_status(slow))
    print("[demo] forensics: rigged slow request explained —",
          file=sys.stderr)
    print("\n".join("    " + ln for ln in exp.table().splitlines()),
          file=sys.stderr)
    if exp.dominant_cause != "queue_wait":
        print(f"[demo] FAIL: rigged request's dominant cause is "
              f"{exp.dominant_cause}, expected queue_wait "
              f"({exp.causes})", file=sys.stderr)
        return 1

    parked = eng.add_request(np.arange(2, 18, dtype=np.int32),
                             max_new_tokens=8)
    for _ in range(400):
        eng.step()
        slot = next((i for i, r in enumerate(eng._active)
                     if r is not None and r.rid == parked), None)
        if slot is not None and slot not in eng._prefilling \
                and len(eng._active[slot].out) >= 2:
            break
    eng.park(parked)
    eng.resume(parked)
    eng.add_request(np.arange(3, 19, dtype=np.int32),
                    max_new_tokens=40, timeout_s=0.02)
    eng.run()
    eng.close()

    # -- fleet-side kinds: route (with rejected candidates), handoff
    # (disaggregated prefill -> decode), requeue (replica death),
    # autoscale (rigged queue-pressure breach), router retire
    rt = ServingRouter(model, replicas=3, prefill_replicas=1,
                       engine_kwargs=dict(kw),
                       kv_tier=KVTierManager(store=LocalStore()),
                       session_checkpoint_steps=1)
    rids = [rt.add_request(np.arange(1 + i, 17 + i, dtype=np.int32),
                           max_new_tokens=8) for i in range(3)]
    victim = None
    for _ in range(500):
        rt.step()
        for rep in rt._replicas.values():
            if rep.dead or not rep.decode_capable():
                continue
            if any(r is not None and i not in rep.engine._prefilling
                   and len(r.out) >= 2
                   for i, r in enumerate(rep.engine._active)):
                victim = rep.id
                break
        if victim is not None:
            break
    if victim is not None:
        rt.kill_replica(victim)
    rt.run()
    scaler = SloAutoscaler(queue_high=0, min_requests=10 ** 6,
                           cooldown_s=0.0)
    scaler.bind(rt)
    scaler.evaluate_once()        # empty queue >= queue_high 0: scale up
    _ = rids

    counts = {}
    for dec in decision_events():
        counts[dec.kind] = counts.get(dec.kind, 0) + 1
    missing = [k for k in DECISION_KINDS if not counts.get(k)]
    if missing:
        print(f"[demo] FAIL: decision kinds never emitted: {missing} "
              f"(saw {counts})", file=sys.stderr)
        return 1
    print("[demo] forensics: every decision kind emitted — "
          + " ".join(f"{k}={counts[k]}" for k in DECISION_KINDS),
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
