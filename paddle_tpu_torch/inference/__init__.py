"""Serving of the port (``paddle_tpu.inference``): the paged KV cache and
its handoff wire format, the continuous-batching engine (slot-contiguous
or paged, speculative decoding, ``aot_warmup``'s CUDA graphs, fleet
roles, the prefill/decode handoff, parkable sessions), the KV tier
manager and the serving fleet router; and the predictor API
(``paddle_tpu/inference/__init__.py:29-166``): ``Config``,
``create_predictor``, ``Predictor`` and ``PredictorPool`` over an
artifact of ``jit.save``.

The predictor runs the loaded ``torch.export`` program (``jit.load``),
whose kernels are ``ptt::`` ops, on the card unless the caller asks for
the CPU (``Config.disable_gpu()`` or ``set_device("cpu")``); the other
knobs of ``Config`` (TensorRT, MKLDNN, IR and memory optimisation,
threads) are recorded and inert, as in the JAX package.  Handles take
and give numpy arrays: ``copy_to_cpu`` widens bfloat16 to float32, as
``hapi.Model.predict_batch`` does.  A pool's predictors share one loaded
program and one set of device parameters, each with its own handles.
The native C++ predictor (``inference/native.py``) waits (ROADMAP.md,
queue 1)."""

from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils import _pytree

from paddle_tpu_torch.inference.kv_cache import (BlockAllocator, PagedCache,
                                                 PagedKVPool, PrefixCache,
                                                 SequenceBlocks,
                                                 deserialize_handoff,
                                                 fetch_handoff,
                                                 paged_cache_attention,
                                                 publish_handoff,
                                                 serialize_handoff)
from paddle_tpu_torch.inference.kv_tier import (KVTierManager,
                                                prefix_block_key,
                                                session_key)
from paddle_tpu_torch.inference.router import (ReplicaWorker,
                                               ServingRouter,
                                               SloAutoscaleRule,
                                               SloAutoscaler,
                                               fetch_result,
                                               submit_request)
from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                QueueFullError,
                                                RequestStatus)

__all__ = ["BlockAllocator", "SequenceBlocks", "PrefixCache", "PagedKVPool",
           "PagedCache", "paged_cache_attention", "serialize_handoff",
           "deserialize_handoff", "publish_handoff", "fetch_handoff",
           "KVTierManager", "prefix_block_key", "session_key",
           "ServingRouter", "SloAutoscaler", "SloAutoscaleRule",
           "ReplicaWorker", "submit_request", "fetch_result",
           "ContinuousBatchingEngine",
           "QueueFullError", "RequestStatus",
           "Config", "Predictor", "create_predictor", "PredictorPool"]


class Config:
    """AnalysisConfig-shaped config.  The GPU / TRT / MKLDNN knobs are
    accepted and recorded for API parity; ``disable_gpu()`` puts the
    predictor on the CPU, the rest are inert."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        if prog_file and prog_file.endswith(".pdmodel"):
            prog_file = prog_file[:-len(".pdmodel")]
        self._model_prefix = prog_file
        self._params_file = params_file
        self._flags: Dict[str, object] = {}

    def set_model(self, prog_file: str, params_file: Optional[str] = None):
        if prog_file.endswith(".pdmodel"):
            prog_file = prog_file[:-len(".pdmodel")]
        self._model_prefix = prog_file
        self._params_file = params_file

    def model_dir(self):
        return self._model_prefix

    # parity knobs (recorded so callers can introspect)
    def enable_use_gpu(self, *a, **k):
        self._flags["use_gpu"] = True

    def disable_gpu(self):
        self._flags["use_gpu"] = False

    def enable_tensorrt_engine(self, *a, **k):
        self._flags["tensorrt"] = True

    def enable_mkldnn(self):
        self._flags["mkldnn"] = True

    def switch_ir_optim(self, flag=True):
        self._flags["ir_optim"] = flag

    def enable_memory_optim(self, flag=True):
        self._flags["memory_optim"] = flag

    def set_cpu_math_library_num_threads(self, n):
        self._flags["cpu_threads"] = n

    def device(self):
        """The predictor's device: the CPU after ``disable_gpu()``, else
        the default device (the card unless ``set_device`` named
        another)."""
        return "cpu" if self._flags.get("use_gpu") is False else None


def _to_numpy(t) -> np.ndarray:
    if not torch.is_tensor(t):
        return np.asarray(t)
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class _Handle:
    """Zero-copy tensor handle (reference ZeroCopyTensor shape)."""

    def __init__(self):
        self._value = None
        self._shape = None

    def copy_from_cpu(self, arr: np.ndarray):
        arr = np.asarray(arr)
        if self._shape is not None:
            arr = arr.reshape(self._shape)
        self._value = arr
        self._shape = None

    def copy_to_cpu(self) -> np.ndarray:
        return _to_numpy(self._value)

    def reshape(self, shape):
        """ZeroCopyTensor::Reshape parity: reallocates to any shape — the
        held value is reshaped when element counts match, otherwise dropped
        and the shape applies to the next copy_from_cpu."""
        shape = tuple(shape)
        if self._value is not None and \
                int(np.prod(self._value.shape)) == int(np.prod(shape)):
            self._value = self._value.reshape(shape)
        else:
            self._value = None
            self._shape = shape

    @property
    def shape(self):
        return None if self._value is None else list(self._value.shape)


class Predictor:
    def __init__(self, config: Config, _shared_layer=None):
        if _shared_layer is not None:
            self._layer = _shared_layer
        else:
            from paddle_tpu_torch.jit.save_load import load
            self._layer = load(config.model_dir(), device=config.device())
        meta = self._layer._meta
        n_in = len(self._layer.input_specs)
        self._input_names = list(
            meta.get("input_names") or [f"x{i}" for i in range(n_in)])
        self._inputs = {n: _Handle() for n in self._input_names}
        self._outputs: List[torch.Tensor] = []

    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_input_handle(self, name: str) -> _Handle:
        return self._inputs[name]

    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """reference AnalysisPredictor::Run / ZeroCopyRun: the outputs as
        numpy arrays (bfloat16 widened to float32)."""
        if inputs is not None:
            for n, arr in zip(self._input_names, inputs):
                self._inputs[n].copy_from_cpu(arr)
        args = [self._inputs[n]._value for n in self._input_names]
        self._outputs = _pytree.tree_leaves(self._layer(*args))
        return [_to_numpy(o) for o in self._outputs]

    def get_output_names(self) -> List[str]:
        return [f"out{i}" for i in range(len(self._outputs))]

    def get_output_handle(self, name: str) -> _Handle:
        h = _Handle()
        h._value = self._outputs[int(name[3:])]
        return h


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


class PredictorPool:
    """Pool sharing ONE loaded program + parameter set across predictors
    (each has its own input/output handles — reference PredictorPool
    clones the program, shares the weights)."""

    def __init__(self, config: Config, size: int = 1):
        first = Predictor(config)
        self._predictors = [first] + [
            Predictor(config, _shared_layer=first._layer)
            for _ in range(size - 1)]

    def retrieve(self, idx: int) -> Predictor:
        return self._predictors[idx]
