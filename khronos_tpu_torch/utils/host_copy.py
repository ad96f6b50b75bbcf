"""Non-blocking device -> host copies.

The active window pulls two kinds of small results every frame or output: the
packed tracker stats and the mesh emission rounds. Each pull is a
non-blocking copy into pinned host memory on the current stream, followed by
a CUDA event; the host polls the event and reads the copy only once it has
landed, so the frame loop never waits for the device. CPU tensors need no
copy and are ready at once.
"""

from __future__ import annotations

import numpy as np
import torch


class HostCopy:
    """Host copies of `tensors`, in flight until `ready()`."""

    def __init__(self, *tensors: torch.Tensor):
        self.tag = None  # caller's label for the pull (e.g. "scroll_final")
        if tensors[0].is_cuda:
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = list(tensors)
            self.event = None

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def numpy(self, i: int) -> np.ndarray:
        """The i-th copy as numpy, waiting for it to land if needed."""
        if self.event is not None:
            self.event.synchronize()
        return self.host[i].numpy()
