"""AMP accuracy debugging (``paddle_tpu/amp/debugging.py``; parity:
``paddle.amp.debugging``).

The per-op NaN/Inf sweep rides the op hook (``core/dispatch.py``,
gated by ``FLAGS_check_nan_inf``); ``check_numerics`` works on any
tensor or array; ``compare_accuracy`` diffs two runs' state dicts.  The
operator stats count each op on the hook by name, as the JAX package's
do (``counts``), and also by the dtype it ran in (``dtypes``: the dtype
of its first floating tensor argument after the AMP cast, as Paddle's
stats split calls into fp16 / bf16 / fp32 / other)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

__all__ = ["TensorCheckerConfig", "enable_tensor_checker",
           "disable_tensor_checker", "check_numerics", "compare_accuracy",
           "DebugMode", "enable_operator_stats_collection",
           "disable_operator_stats_collection", "collect_operator_stats"]


class DebugMode:
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 2


@dataclasses.dataclass
class TensorCheckerConfig:
    enable: bool = True
    debug_mode: int = DebugMode.CHECK_NAN_INF_AND_ABORT
    output_dir: Optional[str] = None
    checked_op_list: Optional[List[str]] = None
    skipped_op_list: Optional[List[str]] = None
    debug_step: Optional[tuple] = None
    stack_height_limit: int = 1


def enable_tensor_checker(config: TensorCheckerConfig):
    from paddle_tpu_torch import flags
    flags.set_flags({
        "check_nan_inf": config.enable,
        "check_nan_inf_level":
            0 if config.debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT
            else 1,
    })


def disable_tensor_checker():
    from paddle_tpu_torch import flags
    flags.set_flags({"check_nan_inf": False})


def _np(value):
    import torch
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.numpy()
    return np.asarray(value)


def check_numerics(tensor, op_type: str = "", var_name: str = "",
                   debug_mode: int = DebugMode.CHECK_NAN_INF_AND_ABORT):
    """Count NaN/Inf in one tensor; returns (num_nan, num_inf, num_zero)
    like the reference's check_numerics stats."""
    arr = _np(tensor)
    num_nan = int(np.isnan(arr).sum())
    num_inf = int(np.isinf(arr).sum())
    num_zero = int((arr == 0).sum())
    if (num_nan or num_inf) and \
            debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT:
        raise FloatingPointError(
            f"check_numerics: {op_type}/{var_name}: {num_nan} NaN, "
            f"{num_inf} Inf in tensor of shape {arr.shape}")
    return num_nan, num_inf, num_zero


def compare_accuracy(run_a_state: dict, run_b_state: dict,
                     rtol: float = 1e-3, atol: float = 1e-6):
    """Diff two runs (e.g. fp32 vs bf16) tensor-by-tensor (reference
    amp/accuracy_compare.py workbook; here: a report list)."""
    report = []
    for name in sorted(set(run_a_state) | set(run_b_state)):
        if name not in run_a_state or name not in run_b_state:
            report.append({"name": name, "status": "missing"})
            continue
        a = np.asarray(_np(run_a_state[name]), np.float64)
        b = np.asarray(_np(run_b_state[name]), np.float64)
        if a.shape != b.shape:
            report.append({"name": name, "status": "shape_mismatch",
                           "a": a.shape, "b": b.shape})
            continue
        diff = np.abs(a - b)
        ok = np.allclose(a, b, rtol=rtol, atol=atol)
        report.append({
            "name": name, "status": "ok" if ok else "mismatch",
            "max_abs_diff": float(diff.max()) if diff.size else 0.0,
            "mean_abs_diff": float(diff.mean()) if diff.size else 0.0,
        })
    return report


# -- op stats (reference debugging.py operator stats collection) -------------

_OP_STATS = {"enabled": False, "counts": {}, "dtypes": {}}


def enable_operator_stats_collection():
    from paddle_tpu_torch.core import dispatch
    _OP_STATS["enabled"] = True
    _OP_STATS["counts"] = {}
    _OP_STATS["dtypes"] = {}
    dispatch.set_stats(True)


def disable_operator_stats_collection():
    from paddle_tpu_torch.core import dispatch
    _OP_STATS["enabled"] = False
    dispatch.set_stats(False)
    counts = _OP_STATS["counts"]
    if counts:
        print(f"{'op':30s} {'calls':>8s}  by dtype")
        for k, v in sorted(counts.items(), key=lambda kv: -kv[1]):
            print(f"{k:30s} {v:8d}  {_OP_STATS['dtypes'].get(k, {})}")
    return counts


class collect_operator_stats:
    """``with collect_operator_stats() as s:`` — on exit ``s.counts``
    holds the calls by op name and ``s.dtypes`` by op name and dtype."""

    def __enter__(self):
        enable_operator_stats_collection()
        return self

    def __exit__(self, *exc):
        self.counts = disable_operator_stats_collection()
        self.dtypes = _OP_STATS["dtypes"]


def record_op(op_name: str, dtype=None):
    if _OP_STATS["enabled"]:
        _OP_STATS["counts"][op_name] = \
            _OP_STATS["counts"].get(op_name, 0) + 1
        name = "other" if dtype is None else \
            str(dtype).replace("torch.", "")
        by = _OP_STATS["dtypes"].setdefault(op_name, {})
        by[name] = by.get(name, 0) + 1
