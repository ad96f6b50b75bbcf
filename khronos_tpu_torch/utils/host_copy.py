"""Non-blocking device -> host copies.

The active window pulls small results every few frames or outputs: the bus
(the packed tracker stats of a batch of frames with the pending mesh
emission metas), a drain round's meta, and each emission round's used rows.
Each pull is a non-blocking copy into pinned host memory on the current
stream of each tensor's card, followed by a CUDA event on each such stream;
the host polls the events and reads the copy only once all have landed, so the
frame loop never waits for the device. CPU tensors need no copy and are
ready at once.

A copy pickles (for checkpoints) as its landed host arrays: pickling waits
for it, and it restores as a copy that is already ready.

A copy made with `earliest=True` waits for itself the first time it is
polled and is then ready: the schedule the CPU gives, where every copy is
ready at once. A window whose copies do so (`ActiveWindow.earliest_pulls`)
consumes each pull at the first poll, so which output a finished track or a
mesh delta lands in no longer depends on the card's timing, and two runs
compare bit for bit.

A wait on a copy that has not landed is the span `wait/<site>`
(`utils/timing.py`); a copy that has landed, or one of CPU tensors, records
nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from khronos_tpu_torch.utils.timing import Wait


class HostCopy:
    """Host copies of `tensors`, in flight until `ready()`. The tensors may
    lie on several cards (a sharded window's pulls): each card's copies
    queue on that card's current stream, with one event a card. Over
    several ranks (`parallel/distributed.py`) a rank pulls only tensors on
    its own card, so its events lie there. `site` names the wait span."""

    def __init__(self, *tensors: torch.Tensor, earliest: bool = False, site: str = "host_copy"):
        self.tag = None  # caller's label for the pull (e.g. "scroll_final")
        self.site = site
        self.host = []
        for t in tensors:
            if t.is_cuda:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)  # on the current stream of t's card
                t = h
            self.host.append(t)
        self.events = []
        for dev in dict.fromkeys(t.device for t in tensors if t.is_cuda):
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))  # the copies' stream on that card
            self.events.append(event)
        self.earliest = earliest

    def ready(self) -> bool:
        if self.earliest:
            self._wait()
            return True
        return all(e.query() for e in self.events)

    def _wait(self) -> None:
        if all(e.query() for e in self.events):
            return
        with Wait(self.site):
            for e in self.events:
                e.synchronize()

    def numpy(self, i: int) -> np.ndarray:
        """The i-th copy as numpy, waiting for it to land if needed."""
        self._wait()
        return self.host[i].numpy()

    def __getstate__(self):
        self._wait()
        return {"tag": self.tag, "host": [h.numpy().copy() for h in self.host]}

    def __setstate__(self, state):
        self.tag = state["tag"]
        self.site = "host_copy"
        self.host = [torch.from_numpy(a) for a in state["host"]]
        self.events = []
        self.earliest = False
