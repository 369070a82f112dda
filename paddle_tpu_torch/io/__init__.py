"""Data loading of the port (``paddle_tpu.io``): device prefetch.  The
datasets and the DataLoader wait (ROADMAP.md, queue 1, item 7)."""

from paddle_tpu_torch.io.device_prefetch import (DevicePrefetchIterator,
                                                 device_prefetch)

__all__ = ["DevicePrefetchIterator", "device_prefetch"]
