"""The port's persistent compile cache (``paddle_tpu_torch/
compile_cache.py``) on the CPU, held to the JAX package's documented
behaviour (its own executables do not load on this jax: ROADMAP.md,
reference faults): keys and fencing, bad entries as misses and unlinked,
atomic stores, the counters and the span, hits that skip the counted
warm-up and leave the compile counter alone, ``TrainStep.compile`` and
the plain call's probe, ``aot_warmup`` (a hit, and ``cache_only=True`` on
an empty cache running eagerly with equal tokens), ``_recover``'s
re-warm, ``warm_on_spawn``, the kernel libraries' cache, ``bundle`` /
``load_bundle`` and the CLI.  Also this slice's small ports: the
``moe.expert_imbalance`` fault point against JAX's and the prefetch
metrics."""

import json
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import paddle_tpu as pp
from paddle_tpu import robustness as jrob
from paddle_tpu.distributed.moe import MoELayer as JMoELayer

from paddle_tpu_torch import compile_cache as CC
from paddle_tpu_torch import robustness as trob
from paddle_tpu_torch.distributed import moe as TM
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.io import device_prefetch
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import default_registry
from paddle_tpu_torch.observability import device_profiler as DP
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.optimizer import AdamW

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
PAGED = dict(slots=2, max_len=64, prefill_buckets=(16, 32),
             kv_block_size=4, prefill_chunk=8, paged_kv=True)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """The cache on, in a temp dir; the in-memory layer forgotten."""
    monkeypatch.setenv("PADDLE_TPU_COMPILE_CACHE", "1")
    monkeypatch.setenv("PADDLE_TPU_COMPILE_CACHE_DIR",
                       str(tmp_path / "cache"))
    CC.reset_memory()
    yield tmp_path / "cache"
    CC.reset_memory()


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


def _model(seed=0):
    from paddle_tpu_torch import seed as tseed
    tseed(seed)
    return LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")


def _batch(i=0):
    ids = np.random.default_rng(i).integers(0, 256, (2, 17))
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


def _entries(root):
    return sorted(n for n in os.listdir(root) if n.endswith(".json"))


# -- keys, entries, fencing ---------------------------------------------------

def test_keys_discriminate_and_name_the_fingerprint(cache):
    k = CC.cache_key("t", "sig", extra="a", device="cpu")
    assert k == CC.cache_key("t", "sig", extra="a", device="cpu")
    assert len({k, CC.cache_key("t2", "sig", extra="a", device="cpu"),
                CC.cache_key("t", "sig2", extra="a", device="cpu"),
                CC.cache_key("t", "sig", extra="b", device="cpu")}) == 4
    assert CC.backend_fingerprint("cpu") == "cpu:cpu:n1"
    with pytest.raises(NotImplementedError, match="item 8"):
        CC.cache_key("t", "sig", mesh=object())
    m = _model()
    assert CC.model_config_tag(m).startswith("LlamaForCausalLM:")


def _store_one(cache, target="t"):
    info = DP.CompileInfo(target=target, signature="s", lower_s=0.0,
                          compile_s=0.0,
                          stats=DP.ExecutableStats(flops=12.0))
    key = CC.cache_key(target, "s", device="cpu")
    assert CC.store(key, info, target=target, signature="s", device="cpu")
    CC.reset_memory()
    return key, os.path.join(cache, f"{key}.json")


def test_store_is_atomic_json_and_counted(cache):
    before = _total("paddle_tpu_compile_cache_total", target="t",
                    result="store")
    key, path = _store_one(cache)
    assert os.listdir(cache) == [f"{key}.json"]       # no tmp left
    entry = json.load(open(path))
    assert entry["schema"] == CC.SCHEMA_VERSION and \
        entry["backend"] == "cpu:cpu:n1" and entry["stats"]["flops"] == 12.0
    assert _total("paddle_tpu_compile_cache_total", target="t",
                  result="store") == before + 1
    hits = _total("paddle_tpu_compile_cache_total", target="t",
                  result="hit")
    assert CC.lookup(key, target="t", device="cpu") is not None
    assert _total("paddle_tpu_compile_cache_total", target="t",
                  result="hit") == hits + 1


@pytest.mark.parametrize("damage", ["corrupt", "truncated", "old_schema",
                                    "cuda_fingerprint", "stale_library"])
def test_bad_entries_are_misses_and_unlinked(cache, damage):
    key, path = _store_one(cache)
    entry = json.load(open(path))
    if damage == "corrupt":
        open(path, "w").write("{not json")
    elif damage == "truncated":
        raw = open(path).read()
        open(path, "w").write(raw[:len(raw) // 2])
    else:
        if damage == "old_schema":
            entry["schema"] = CC.SCHEMA_VERSION - 1
        elif damage == "cuda_fingerprint":
            # a CUDA entry is never served to a CPU process (nor the
            # reverse: the fingerprint is in the key and re-checked)
            entry["backend"] = "cuda:NVIDIA_H100_80GB_HBM3:n1"
        else:
            entry["kernels"] = {"multi_tensor": "0" * 16}
        json.dump(entry, open(path, "w"))
    before = _total("paddle_tpu_compile_cache_total", target="t",
                    result="miss")
    assert CC.lookup(key, target="t", device="cpu") is None
    assert not os.path.exists(path)
    assert _total("paddle_tpu_compile_cache_total", target="t",
                  result="miss") == before + 1


def test_library_load_failure_is_a_deserialize_error(cache, monkeypatch):
    key, path = _store_one(cache)
    entry = json.load(open(path))
    entry["kernels"] = {"multi_tensor": _build.library_key("multi_tensor")}
    json.dump(entry, open(path, "w"))

    def refuse(name):
        raise OSError("cannot load")
    monkeypatch.setattr(_build, "library", refuse)
    before = _total("paddle_tpu_compile_cache_total", target="t",
                    result="deserialize_error")
    assert CC.lookup(key, target="t", device="cpu") is None
    assert not os.path.exists(path)
    assert _total("paddle_tpu_compile_cache_total", target="t",
                  result="deserialize_error") == before + 1


# -- hits --------------------------------------------------------------------

def test_train_step_hit_skips_the_count_and_matches_live(cache):
    target = "TrainStep(LlamaForCausalLM)"
    live = TrainStep(_model(), AdamW(learning_rate=1e-3))
    c0 = _total("paddle_tpu_compile_total", target=target)
    info = live.compile(_batch())
    assert not info.cached and info.stats.flops > 0
    assert _total("paddle_tpu_compile_total", target=target) == c0 + 1
    assert len(_entries(cache)) == 1
    loss_live = live(_batch()).numpy().tobytes()

    from paddle_tpu_torch.analysis.passes import cost_model
    counted = []
    orig = cost_model.count_cost
    hit_step = TrainStep(_model(), AdamW(learning_rate=1e-3))
    try:
        cost_model.count_cost = lambda *a, **k: counted.append(1) or \
            orig(*a, **k)
        hit = hit_step.compile(_batch())
    finally:
        cost_model.count_cost = orig
    assert hit.cached and counted == []
    assert hit.stats.flops == info.stats.flops
    assert _total("paddle_tpu_compile_total", target=target) == c0 + 1
    assert DP.compile_records(target)[-1].cached
    assert hit_step(_batch()).numpy().tobytes() == loss_live
    # the plain call's probe: a step never compiled adopts the entry
    probe = TrainStep(_model(), AdamW(learning_rate=1e-3))
    assert probe(_batch()).numpy().tobytes() == loss_live
    assert probe._sig is not None
    # a miss on the probe leaves the call eager
    other = TrainStep(_model(), AdamW(learning_rate=1e-3))
    other(_batch(1) | {"input_ids": _batch(1)["input_ids"][:1],
                       "labels": _batch(1)["labels"][:1]})
    assert other._sig is None


def test_cache_extra_is_jaxs_string():
    st = TrainStep(_model(), AdamW(learning_rate=1e-3), accum_steps=2,
                   remat=True, remat_policy="dots")
    assert st._cache_extra().split("|")[1:] == [
        "opt=AdamW", "loss=", "accum=2", "remat=1:dots", "guard=1", "ovl=0"]
    eng = ContinuousBatchingEngine(_model(), **PAGED)
    assert eng._cache_extra().split("|")[1:] == [
        "gc=False:1.0:0:1.0", "K=1", "int8=0", "paged=1", "spec=0",
        "qw=-", "qkv=-"]


def _serve(eng, prompts):
    for p in prompts:
        eng.add_request(p, max_new_tokens=4)
    return {rid: list(toks) for rid, (_, toks) in eng.run().items()}


PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7, 6, 5, 4, 3, 2, 1, 0, 11]]


def test_aot_warmup_hit_and_cache_only_miss_serve_equal_tokens(cache,
                                                               tmp_path,
                                                               monkeypatch):
    m = _model()
    eager = _serve(ContinuousBatchingEngine(m, **PAGED), PROMPTS)
    first = ContinuousBatchingEngine(m, **PAGED)
    st = first.aot_warmup()
    assert not any(v["cached"] for v in st.values())
    assert _serve(first, PROMPTS) == eager
    second = ContinuousBatchingEngine(m, **PAGED)
    c0 = _total("paddle_tpu_compile_total", target="serving.decode")
    st = second.aot_warmup()
    assert all(v["cached"] for v in st.values())
    assert _total("paddle_tpu_compile_total",
                  target="serving.decode") == c0
    assert _serve(second, PROMPTS) == eager
    # an empty cache: cache_only captures nothing and serves eagerly
    monkeypatch.setenv("PADDLE_TPU_COMPILE_CACHE_DIR", str(tmp_path / "e"))
    CC.reset_memory()
    third = ContinuousBatchingEngine(m, **PAGED)
    st = third.aot_warmup(cache_only=True)
    assert all(v["eager"] and not v["graph"] for v in st.values())
    assert third._graphs == {} and not os.path.exists(tmp_path / "e")
    assert _serve(third, PROMPTS) == eager


def test_recover_rewarms_from_the_cache(cache):
    m = _model()
    ContinuousBatchingEngine(m, **PAGED).aot_warmup()     # stores
    eng = ContinuousBatchingEngine(m, **PAGED)
    hits = _total("paddle_tpu_compile_cache_total",
                  target="serving.decode", result="hit")
    eng.add_request(PROMPTS[0], max_new_tokens=4)
    trob.inject("serving.engine_step", times=1)
    eng.step()
    assert _total("paddle_tpu_compile_cache_total",
                  target="serving.decode", result="hit") == hits + 1
    assert "serving.decode" in eng._graphs
    eng.add_request(PROMPTS[1], max_new_tokens=4)
    assert len(eng.run()) >= 1


def test_warm_on_spawn_follows_the_cache(cache, monkeypatch):
    from paddle_tpu_torch.inference.router import ServingRouter
    m = _model()
    assert ServingRouter(m, engine_kwargs=PAGED)._warm_on_spawn
    monkeypatch.setenv("PADDLE_TPU_COMPILE_CACHE", "0")
    assert not ServingRouter(m, engine_kwargs=PAGED)._warm_on_spawn


# -- kernel libraries ----------------------------------------------------------

def test_kernel_libraries_come_from_the_cache(cache, tmp_path, monkeypatch):
    """A library missing from build/ is copied from <cache>/kernels (no
    nvcc run); one found in build/ is stored there, with its sha256
    beside it."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "SOURCES", ("multi_tensor", "rmsnorm"))
    kdir = cache / "kernels"
    (tmp_path / "lib1").write_bytes(b"lib one")
    _build.store_library(
        tmp_path / "lib1",
        kdir / f"libmulti_tensor-{_build.library_key('multi_tensor')}.so")
    (tmp_path / "build").mkdir()
    _build._target("rmsnorm").write_bytes(b"lib two")
    runs = _build.nvcc_runs()
    assert _build.build_all() == 0.0
    assert _build.nvcc_runs() == runs
    assert _build._target("multi_tensor").read_bytes() == b"lib one"
    stored = kdir / f"librmsnorm-{_build.library_key('rmsnorm')}.so"
    assert stored.read_bytes() == b"lib two" and _build.verified(stored)


class _FakeNvcc:
    """Stands in for nvcc's process: writes `lib`'s bytes to the
    command's ``-o`` path and succeeds."""

    def __init__(self, lib):
        self.lib, self.returncode = lib, 0

    def __call__(self, cmd, **kw):
        shutil.copyfile(self.lib, cmd[cmd.index("-o") + 1])
        return self

    def communicate(self):
        return b"", None


@pytest.fixture
def fake_kernels(cache, tmp_path, monkeypatch):
    """One kernel library, `fake`, whose source lives in a temp csrc/ and
    whose 'nvcc' is g++'s build of a two-function C file; the build
    directory and the loaded libraries are the test's own."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "fake.cu").write_text("// a stand-in source\n")
    c = tmp_path / "fake.c"
    c.write_text("int ptt_fake(void) { return 7; }\n"
                 "const char* ptt_error_string(int e) { return \"\"; }\n")
    lib = tmp_path / "fake.so"
    subprocess.run(["gcc", "-shared", "-fPIC", "-o", str(lib), str(c)],
                   check=True, timeout=60)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "SOURCES", ("fake",))
    monkeypatch.setattr(_build, "_SIGNATURES", {"fake": {"ptt_fake": []}})
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", _FakeNvcc(lib))
    return cache / "kernels" / f"libfake-{_build.library_key('fake')}.so"


@pytest.mark.parametrize("damage", ["truncated", "no_digest"])
def test_a_damaged_cached_library_is_rebuilt_by_nvcc(fake_kernels, damage):
    """A cached library whose bytes do not match its recorded sha256 (or
    that has none) is unlinked, never copied into build/, and rebuilt by
    nvcc, counted; the rebuilt library is stored in its place."""
    runs = _build.nvcc_runs()
    _build.build_all()
    assert _build.nvcc_runs() == runs + 1 and _build.verified(fake_kernels)
    good = fake_kernels.read_bytes()
    _build._target("fake").unlink()
    if damage == "truncated":
        fake_kernels.write_bytes(good[:len(good) // 2])
    else:
        fake_kernels.with_name(fake_kernels.name + ".sha256").unlink()
    assert _build.build_all() > 0.0
    assert _build.nvcc_runs() == runs + 2
    assert _build._target("fake").read_bytes() == good
    assert _build.verified(fake_kernels)
    assert _build.library("fake").ptt_fake() == 7


def test_a_library_that_fails_to_load_is_rebuilt_by_nvcc(fake_kernels):
    """A library in build/ that does not load (truncated) is unlinked
    there and in the cache and rebuilt by nvcc, counted; it never gives
    way to a plain version."""
    _build.build_all()
    runs = _build.nvcc_runs()
    good = _build._target("fake").read_bytes()
    _build._target("fake").write_bytes(good[:100])
    assert _build.library("fake").ptt_fake() == 7
    assert _build.nvcc_runs() == runs + 1
    assert _build._target("fake").read_bytes() == good
    assert _build.verified(fake_kernels)


def test_a_library_that_cannot_be_rebuilt_raises(fake_kernels, tmp_path,
                                                 monkeypatch):
    """A rebuilt library that still does not load raises."""
    _build.build_all()
    _build._target("fake").write_bytes(b"not a library")
    (tmp_path / "junk").write_bytes(b"not a library either")
    monkeypatch.setattr(_build.subprocess, "Popen",
                        _FakeNvcc(tmp_path / "junk"))
    runs = _build.nvcc_runs()
    with pytest.raises(OSError):
        _build.library("fake")
    assert _build.nvcc_runs() == runs + 1


# -- bundles -----------------------------------------------------------------

def test_bundle_round_trip(cache, tmp_path, monkeypatch):
    m = _model()
    TrainStep(m, AdamW(learning_rate=1e-3)).compile(_batch())
    ContinuousBatchingEngine(m, **PAGED).aot_warmup()
    (tmp_path / "x").write_bytes(b"x")
    _build.store_library(tmp_path / "x", cache / "kernels" / "libx-0123.so")
    # a cached library whose recorded digest does not match stays out
    _build.store_library(tmp_path / "x", cache / "kernels" / "liby-0.so",
                         sha256="0" * 64)
    man = CC.bundle(str(tmp_path / "b"), state_dict=m.state_dict(),
                    device="cpu", note="tiny")
    assert len(man["executables"]) == 3
    assert man["kernels"] == {"libx-0123.so": _build.file_sha256(
        tmp_path / "x")}
    assert man["autotune_entries"] == 0 and man["backend"] == "cpu:cpu:n1"
    # a foreign entry in the bundle is skipped, counted as a miss
    foreign = json.load(open(tmp_path / "b" / "executables" /
                             f"{man['executables'][0]['key']}.json"))
    foreign["backend"] = "cuda:X:n1"
    json.dump(foreign, open(tmp_path / "b" / "executables" / "f.json", "w"))
    out = CC.load_bundle(str(tmp_path / "b"), cache_root=str(tmp_path / "n"),
                         device="cpu")
    assert sorted(out["installed"]) == sorted(
        e["target"] for e in man["executables"])
    assert out["skipped"] == 1 and out["kernels"] == ["libx-0123.so"]
    assert out["rejected"] == []
    assert _build.verified(tmp_path / "n" / "kernels" / "libx-0123.so")
    assert os.path.exists(tmp_path / "b" / "executables" / "f.json")
    sd = m.state_dict()
    for k, v in out["state_dict"].items():
        assert torch.equal(v, sd[k]), k
    # the installed cache serves the next boot
    monkeypatch.setenv("PADDLE_TPU_COMPILE_CACHE_DIR", str(tmp_path / "n"))
    CC.reset_memory()
    assert all(v["cached"] for v in ContinuousBatchingEngine(
        m, **PAGED).aot_warmup().values())
    with pytest.raises(ValueError, match="not a model bundle"):
        CC.load_bundle(str(tmp_path), device="cpu")


def test_load_bundle_rejects_a_damaged_library(cache, tmp_path):
    """A bundled library whose bytes do not match the manifest's sha256
    (truncated in transit) is not installed: nvcc rebuilds it; the
    entries and the weights still install."""
    _store_one(cache)
    (tmp_path / "lib").write_bytes(b"0123456789" * 100)
    _build.store_library(tmp_path / "lib", cache / "kernels" / "liba-1.so")
    _build.store_library(tmp_path / "lib", cache / "kernels" / "libb-2.so")
    CC.bundle(str(tmp_path / "b"), state_dict={"w": torch.ones(3)},
              device="cpu")
    with open(tmp_path / "b" / "kernels" / "liba-1.so", "r+b") as f:
        f.truncate(500)
    out = CC.load_bundle(str(tmp_path / "b"), cache_root=str(tmp_path / "n"),
                         device="cpu")
    assert out["rejected"] == ["liba-1.so"] and out["kernels"] == ["libb-2.so"]
    assert not os.path.exists(tmp_path / "n" / "kernels" / "liba-1.so")
    assert _build.verified(tmp_path / "n" / "kernels" / "libb-2.so")
    assert len(out["installed"]) == 1
    assert torch.equal(out["state_dict"]["w"], torch.ones(3))


def test_cli(cache, tmp_path, capsys):
    _store_one(cache)
    assert CC.main(["--device", "cpu", "stats"]) == 0
    assert '"entries": 1' in capsys.readouterr().out
    assert CC.main(["--device", "cpu", "bundle", str(tmp_path / "b")]) == 0
    assert CC.main(["--device", "cpu", "load-bundle",
                    str(tmp_path / "b")]) == 0
    assert "installed 1 entries" in capsys.readouterr().out
    assert CC.main(["--device", "cpu", "clear"]) == 0
    assert CC.cached_entries(device="cpu") == []


# -- the small ones ------------------------------------------------------------

def test_moe_expert_imbalance_fault_matches_jax():
    """The fault biases expert 0 by 10 in both packages: the same
    routing, so the same load, aux loss and output."""
    pp.seed(0)
    jl = JMoELayer(16, 4, d_hidden=8)
    tl = TM.MoELayer(16, 4, d_hidden=8)
    tl.set_state_dict({k: np.asarray(v.numpy())
                       for k, v in jl.state_dict().items()})
    x = np.random.default_rng(0).standard_normal((2, 6, 16)).astype(
        np.float32)
    jrob.inject("moe.expert_imbalance", times=1)
    trob.inject("moe.expert_imbalance", times=1)
    jy = np.asarray(jl(pp.to_tensor(x)).numpy())
    ty = tl(torch.from_numpy(x))
    assert trob.fault_stats("moe.expert_imbalance")["fires"] == 1
    load = tl.router_stats["load"]
    assert int(load[0]) == int(load.max()) > int(load[1:].max())
    np.testing.assert_allclose(ty.detach().numpy(), jy, atol=1e-5, rtol=1e-5)


def test_prefetch_metrics():
    depth = default_registry().get("paddle_tpu_prefetch_depth")
    b0 = _total("paddle_tpu_prefetch_batches_total")
    it = device_prefetch(({"x": np.full((2,), i)} for i in range(5)),
                         depth=2, device="cpu")
    with it:
        got = [int(b["x"][0]) for b in it]
    assert got == [0, 1, 2, 3, 4]
    assert _total("paddle_tpu_prefetch_batches_total") == b0 + 5
    depth = default_registry().get("paddle_tpu_prefetch_depth")
    assert depth is not None
    assert not it._thread.is_alive()
