"""The split-K rule that the quant matmul and QKV's decode rows share —
the Python side of ``csrc/splitk.cuh``.

The C entries size their own launches (``ptt_quant_splits``,
``ptt_qkv_splits``) and the wrappers ask them; this module is the rule's
model for the tests and for reports, and names the constants the
wrappers size a launch's tickets with."""

from __future__ import annotations

__all__ = ["splitk_splits", "SPLITK_MAX_T", "SPLITK_BN", "SPLIT_FACTOR",
           "MIN_SLICES", "MAX_SPLIT_DEPTH"]

# csrc/splitk.cuh's constants: the largest T split-K takes (kSplitKMaxT),
# the output columns of a block (kSkBN), and the split rule's default
# blocks per SM (kSplitFactor), least 64-deep slices a split (kMinSlices)
# and deepest split (kMaxSplitDepth)
SPLITK_MAX_T = 16
SPLITK_BN = 128
SPLIT_FACTOR = 2
MIN_SLICES = 4
MAX_SPLIT_DEPTH = 2048


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
