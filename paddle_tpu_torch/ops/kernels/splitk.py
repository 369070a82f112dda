"""The split-K rules of the decode-row kernels — the Python side of
``csrc/splitk.cuh`` (the quant matmul's and QKV's rule) and of the MLP's
(``mlp_splits`` in ``csrc/fused_block.cu``, on splitk.cuh's strip
stream).

The C entries size their own launches; the quant matmul's and QKV's
wrappers ask them for the split count (``ptt_quant_splits``,
``ptt_qkv_splits``), while the MLP's wrapper sizes its workspace by
``mlp_splits`` here and the C entry refuses one smaller than its own
count needs.  This module names the constants the wrappers size a
launch's tickets with, and is the rules' model for the tests."""

from __future__ import annotations

__all__ = ["splitk_splits", "mlp_splits", "SPLITK_MAX_T", "SPLITK_BN",
           "SPLIT_FACTOR", "MIN_SLICES", "MAX_SPLIT_DEPTH", "MLP_BN"]

# csrc/splitk.cuh's constants: the largest T split-K takes (kSplitKMaxT),
# the output columns of a block (kSkBN), and the split rule's default
# blocks per SM (kSplitFactor), least 64-deep slices a split (kMinSlices)
# and deepest split (kMaxSplitDepth)
SPLITK_MAX_T = 16
SPLITK_BN = 128
SPLIT_FACTOR = 2
MIN_SLICES = 4
MAX_SPLIT_DEPTH = 2048
# the MLP's output columns a block (csrc/fused_block.cu, kMlpBN): four
# warps, a 64-column strip each
MLP_BN = 256


def splitk_splits(K: int, N: int, sms: int,
                  factor: int = SPLIT_FACTOR) -> int:
    """The K splits of a split-K kernel (``splitk_splits`` in
    ``csrc/splitk.cuh``): enough blocks for `factor` a SM over the
    128-column tiles, at least MIN_SLICES 64-deep slices a split, none
    deeper than MAX_SPLIT_DEPTH, never more splits than slices."""
    tiles = -(-N // SPLITK_BN)
    slices = K // 64
    s = -(-(factor * sms) // tiles)
    s = min(s, max(1, slices // MIN_SLICES))
    s = max(s, -(-K // MAX_SPLIT_DEPTH))
    return min(s, slices)


def mlp_splits(K: int, N: int, sms: int) -> int:
    """The K splits of one MLP split-K launch (``mlp_splits`` in
    ``csrc/fused_block.cu``): one wave of a block a SM over the
    MLP_BN-column tiles where they leave room, never more splits than
    64-deep slices."""
    return min(max(1, sms // -(-N // MLP_BN)), K // 64)
