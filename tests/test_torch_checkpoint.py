"""The port's checkpoint (``paddle_tpu_torch/distributed/checkpoint.py``)
against the JAX package's on the CPU: format 2 file for file and byte
for byte in both directions (fp32, bf16, int8, fp8, bool, 0-d), JAX's
sharded saves and format 1 loaded whole, the digests and both validators
on a torn shard, the crash-before-publish orphan, the async writer,
``AutoCheckpoint`` (keep, latest, restore past a corrupt step), the
``Converter``'s merge / slice, bf16 with ``ml_dtypes`` hidden from the
port, and a JAX-saved tiny Llama's weights running the port's model
(logits within 1e-5 of JAX's).

JAX's own ``load_state_dict`` cannot read a bf16 or fp8 file, its own
or the port's (numpy has no cast from the file's void dtype; ROADMAP.md,
reference faults): for those two the port's files are held equal to
JAX's bytes and to JAX's validator instead."""

import filecmp
import json
import os
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pp
from paddle_tpu import robustness as jrob
from paddle_tpu.distributed import checkpoint as J
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM

from paddle_tpu_torch import robustness as trob
from paddle_tpu_torch.distributed import checkpoint as T
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM


@pytest.fixture(autouse=True)
def _clean_faults():
    jrob.clear_faults()
    trob.clear_faults()
    yield
    jrob.clear_faults()
    trob.clear_faults()


def _arrays(kind):
    """numpy arrays (ml_dtypes for bf16 / fp8) of one kind, from a seed."""
    rng = np.random.default_rng(7)
    f = rng.standard_normal((5, 3)).astype(np.float32)
    return {
        "float32": {"w": f, "x/y": f[:, :2].copy()},
        "bfloat16": {"w": f.astype(ml_dtypes.bfloat16)},
        "int8": {"q": rng.integers(-128, 128, (4, 6)).astype(np.int8)},
        "float8_e4m3fn": {"w": f.astype(ml_dtypes.float8_e4m3fn)},
        "bool": {"m": rng.random((3, 4)) > 0.5},
        "0-d": {"s": np.float32(2.5), "n": np.int32(-3)},
    }[kind]


def _tensor(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _bits(t):
    """A tensor's bytes (and shape), for bitwise comparison."""
    t = t.detach().cpu().contiguous()
    return tuple(t.shape), t.reshape(-1).view(torch.uint8).numpy().tobytes()


def _np_bits(a):
    a = np.array(a, copy=True, order="C")
    return a.shape, a.tobytes()


KINDS = ["float32", "bfloat16", "int8", "float8_e4m3fn", "bool", "0-d"]
JAX_LOADS = {"float32", "int8", "bool", "0-d"}


@pytest.mark.parametrize("kind", KINDS)
def test_jax_saved_loads_in_the_port_bitwise(tmp_path, kind):
    arrs = _arrays(kind)
    J.save_state_dict({k: jnp.asarray(v) for k, v in arrs.items()},
                      str(tmp_path))
    assert T.validate_checkpoint(str(tmp_path))
    got = T.load_state_dict(str(tmp_path), device="cpu")
    assert set(got) == set(arrs)
    for k, v in arrs.items():
        assert _bits(got[k]) == _np_bits(v), k


@pytest.mark.parametrize("kind", KINDS)
def test_port_saved_equals_jax_files_and_loads_there(tmp_path, kind):
    arrs = _arrays(kind)
    J.save_state_dict({k: jnp.asarray(v) for k, v in arrs.items()},
                      str(tmp_path / "jax"))
    T.save_state_dict({k: _tensor(v) for k, v in arrs.items()},
                      str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for n in names:
        assert filecmp.cmp(tmp_path / "jax" / n, tmp_path / "port" / n,
                           shallow=False), n
    assert J.validate_checkpoint(str(tmp_path / "port"))
    if kind in JAX_LOADS:
        back = J.load_state_dict(str(tmp_path / "port"))
        for k, v in arrs.items():
            assert _np_bits(back[k]) == _np_bits(v), k


def test_numpy_values_and_cuda_default(tmp_path):
    """save_state_dict takes numpy (ml_dtypes too); load's default
    device is cuda, which raises on a machine without it."""
    arrs = {**_arrays("bfloat16"), **_arrays("int8")}
    T.save_state_dict(arrs, str(tmp_path))
    got = T.load_state_dict(str(tmp_path), device="cpu")
    for k, v in arrs.items():
        assert _bits(got[k]) == _np_bits(v)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.load_state_dict(str(tmp_path))


def test_jax_sharded_save_loads_whole(tmp_path):
    """A JAX save over the 8-device CPU mesh (8 shard files a tensor)
    loads whole in the port, bitwise."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("a", "b"))
    w = np.random.default_rng(1).standard_normal((8, 6)).astype(np.float32)
    arr = jax.device_put(w, NamedSharding(mesh, P("a", "b")))
    J.save_state_dict({"w": arr, "bf": arr.astype(jnp.bfloat16)},
                      str(tmp_path))
    idx = json.load(open(tmp_path / "index.0.json"))
    assert len(idx["tensors"]["w"]["shards"]) == 8
    got = T.load_state_dict(str(tmp_path), device="cpu")
    assert _bits(got["w"]) == _np_bits(w)
    assert _bits(got["bf"]) == _np_bits(w.astype(ml_dtypes.bfloat16))


def test_format_1_loads_in_both(tmp_path):
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.save(tmp_path / "w.npy", w)
    np.save(tmp_path / "b.npy", np.array([True, False]))
    json.dump({"format": 1, "tensors": {"w": {"file": "w.npy"},
                                        "b": {"file": "b.npy"}}},
              open(tmp_path / "checkpoint_meta.json", "w"))
    got = T.load_state_dict(str(tmp_path), device="cpu")
    ref = J.load_state_dict(str(tmp_path))
    for k in ("w", "b"):
        assert _bits(got[k]) == _np_bits(ref[k])
    assert T.validate_checkpoint(str(tmp_path))


def test_sha256_digest_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_CKPT_DIGEST", "sha256")
    arrs = _arrays("float32")
    J.save_state_dict({k: jnp.asarray(v) for k, v in arrs.items()},
                      str(tmp_path / "jax"))
    T.save_state_dict({k: _tensor(v) for k, v in arrs.items()},
                      str(tmp_path / "port"))
    ji = json.load(open(tmp_path / "jax" / "index.0.json"))
    ti = json.load(open(tmp_path / "port" / "index.0.json"))
    assert ji == ti
    assert all("sha256" in s for t in ti["tensors"].values()
               for s in t["shards"])


def test_torn_shard_caught_by_both_validators(tmp_path):
    """checkpoint.torn_shard truncates a file after its digest: the
    port's and JAX's validators both refuse it (the metadata-only check
    does not see it)."""
    trob.inject("checkpoint.torn_shard", times=1)
    T.save_state_dict({"w": torch.ones(64, 64)}, str(tmp_path))
    assert trob.fault_stats("checkpoint.torn_shard")["fires"] == 1
    assert not T.validate_checkpoint(str(tmp_path))
    assert not J.validate_checkpoint(str(tmp_path))
    assert T.validate_checkpoint(str(tmp_path), verify_digests=False)


def test_crash_before_publish_leaves_an_orphan_the_next_save_purges(
        tmp_path):
    trob.inject("checkpoint.shard_write", times=1)
    with pytest.raises(RuntimeError):
        T.save_state_dict({"w": torch.ones(3)}, str(tmp_path))
    names = os.listdir(tmp_path)
    assert names and all(".tmp." in n for n in names)
    assert not T.validate_checkpoint(str(tmp_path))
    T.save_state_dict({"w": torch.ones(3)}, str(tmp_path))
    assert not any(".tmp." in n for n in os.listdir(tmp_path))
    assert T.validate_checkpoint(str(tmp_path))


def test_async_save_waits_and_reraises(tmp_path):
    h = T.async_save_state_dict({"w": torch.arange(10.0)},
                                str(tmp_path / "ok"))
    h.wait(timeout=30)
    assert h.done() and T.validate_checkpoint(str(tmp_path / "ok"))
    assert h.thread.daemon
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    bad = T.async_save_state_dict({"w": torch.ones(2)}, str(blocker))
    with pytest.raises(OSError):
        bad.wait(timeout=30)


def test_autocheckpoint_keep_latest_and_restore(tmp_path):
    ck = T.AutoCheckpoint(str(tmp_path), keep=2, save_interval_steps=2)
    assert ck.maybe_save(1, {"w": torch.zeros(2)}) is None
    for step in (2, 4, 6):
        pending = ck.maybe_save(step, {"w": torch.full((2,), float(step))})
    pending.wait(timeout=30)
    assert sorted(os.listdir(tmp_path)) == ["step_000000000004",
                                            "step_000000000006"]
    assert ck.latest_step() == 6
    step, st = ck.restore_latest(device="cpu")
    assert step == 6 and st["w"].tolist() == [6.0, 6.0]
    # corrupt the newest: restore falls back to step 4
    f = [n for n in os.listdir(tmp_path / "step_000000000006")
         if n.endswith(".npy")][0]
    with open(tmp_path / "step_000000000006" / f, "r+b") as fh:
        fh.seek(-1, 2)
        fh.write(b"\x01")
    assert ck.latest_step() == 4
    step, st = ck.restore_latest(device="cpu")
    assert step == 4 and st["w"].tolist() == [4.0, 4.0]
    # the same directory reads the same under JAX's AutoCheckpoint
    assert J.AutoCheckpoint(str(tmp_path), keep=2).latest_step() == 4
    path = ck.save_now(8, {"w": torch.ones(2)})
    assert T.validate_checkpoint(path) and ck.latest_step() == 8


def test_converter_merge_and_slice_equal_jax():
    g = np.arange(48, dtype=np.float32).reshape(6, 8)
    attr = {"dims_mapping": [0, 1], "process_shape": [2, 2],
            "process_group": [0, 1, 2, 3]}
    shards = T.Converter.slice_with_dist_attr(g, attr)
    jshards = J.Converter.slice_with_dist_attr(g, attr)
    for a, b in zip(shards, jshards):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        T.Converter.merge_with_dist_attr(shards, attr), g)
    with pytest.raises(NotImplementedError, match="item 8"):
        T.Converter("x").convert(None, {})
    with pytest.raises(NotImplementedError, match="item 8"):
        T.load_state_dict("x", mesh=object(), device="cpu")


def test_bf16_without_ml_dtypes(tmp_path, monkeypatch):
    """With ml_dtypes hidden from the port, a bf16 tensor saves to JAX's
    bytes and a JAX-saved bf16 file loads bitwise."""
    w = np.random.default_rng(3).standard_normal((4, 4)).astype(
        ml_dtypes.bfloat16)
    J.save_state_dict({"w": jnp.asarray(w)}, str(tmp_path / "jax"))
    t = _tensor(w)
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    T.save_state_dict({"w": t}, str(tmp_path / "port"))
    got = T.load_state_dict(str(tmp_path / "jax"), device="cpu")
    assert _bits(got["w"]) == _bits(t)
    for n in os.listdir(tmp_path / "jax"):
        assert filecmp.cmp(tmp_path / "jax" / n, tmp_path / "port" / n,
                           shallow=False)


def test_jax_saved_llama_runs_in_the_port(tmp_path):
    """A tiny fp32 Llama's weights saved by JAX load into the port's
    model: logits within 1e-5 of JAX's on the same ids."""
    tiny = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=128)
    pp.seed(0)
    jm = JLlamaForCausalLM(JLlamaConfig.tiny(**tiny))
    J.save_state_dict({k: v._data if hasattr(v, "_data") else v
                       for k, v in jm.state_dict().items()}, str(tmp_path))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**tiny), device="cpu")
    tm.set_state_dict(T.load_state_dict(str(tmp_path), device="cpu"))
    ids = np.random.default_rng(0).integers(0, 256, (2, 12))
    ref = np.asarray(jm(pp.to_tensor(ids.astype(np.int32))).numpy())
    with torch.no_grad():
        got = tm(torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
