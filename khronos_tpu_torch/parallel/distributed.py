"""Several processes ("ranks") over one global device mesh.

The port's counterpart of `jax.distributed.initialize` and of the
collectives XLA inserts when the reference's sharded step runs over a
global mesh spanning processes (tests/multihost_worker.py,
tests/multihost_pipeline_worker.py). Every rank runs the same program
(SPMD): the host state and the pixel side are replicated, each rank computes
only the slabs it owns, and the ranks exchange what crosses a slab boundary
through a small group interface:

- `rank`, `size`, `device` (this rank's device) and `devices` (every rank's,
  in rank order);
- `all_gather(tensor)`: every rank's tensor of the same shape and dtype, in
  rank order, on this rank's device, bit for bit (tensors travel as bytes, so
  -0.0 and NaN payloads survive);
- `barrier()`.

Three implementations; the caller picks one, and nothing picks one by
catching an error:

- `ThreadGroup`: W ranks as threads of one process meeting at a
  `threading.Barrier` (the tests; `run_threads` starts them);
- `TorchGroup` over `backend="gloo"`: `torch.distributed` on CPU tensors, a
  CUDA tensor staged through host memory explicitly. Any number of ranks on
  any number of cards, two ranks on one card included;
- `TorchGroup` over `backend="nccl"`: CUDA tensors, one rank a card; it
  raises before init when two ranks would share a card.

Rank r's device is `cuda:(r % device_count)`, or the CPU when the caller asks
for it. Every collective has a timeout: a hang becomes an error naming the
rank and the call. A group counts its collectives (`calls`), the bytes its
all_gathers return (`gathered_bytes`) and the host's seconds inside them
(`seconds`).
"""

from __future__ import annotations

import datetime
import threading
import time
from typing import Callable, List, Optional, Sequence

import torch

DEFAULT_TIMEOUT_S = 300.0


def rank_device(rank: int, device="cuda") -> torch.device:
    """Rank r's device: cuda:(r % visible cards), or the CPU when asked."""
    d = torch.device(device)
    if d.type == "cpu":
        return d
    if d.type != "cuda":
        raise ValueError(f"rank_device: unsupported device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("rank_device: no GPU is visible; pass device='cpu' to run the ranks on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes as a flat uint8 tensor (a copy where it must be)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return b.view(like.dtype).reshape(like.shape)


class Group:
    """The interface the sharded window uses (see the module docstring).
    `calls` and `gathered_bytes` count this rank's collectives and the bytes
    its all_gathers returned; `seconds` is the host's time inside its
    all_gathers, from the moment its own tensor is ready (waiting for the
    other ranks included)."""

    rank: int
    size: int
    device: torch.device
    devices: tuple
    timeout_s: float
    calls: int = 0
    gathered_bytes: int = 0
    seconds: float = 0.0

    def all_gather(self, tensor: torch.Tensor) -> List[torch.Tensor]:
        raise NotImplementedError

    def barrier(self) -> None:
        raise NotImplementedError


class _Hub:
    """What the threads of one ThreadGroup share."""

    def __init__(self, size: int, timeout_s: float):
        self.barrier = threading.Barrier(size, timeout=timeout_s)
        self.slots: list = [None] * size


class ThreadGroup(Group):
    """One rank of W ranks that are threads of this process. `create` makes
    the W handles; `run_threads` runs a function in each."""

    def __init__(self, hub: _Hub, rank: int, devices: Sequence, timeout_s: float):
        self._hub = hub
        self.rank, self.size = rank, len(devices)
        self.devices = tuple(torch.device(d) for d in devices)
        self.device = self.devices[rank]
        self.timeout_s = timeout_s

    @classmethod
    def create(cls, size: int, devices: Optional[Sequence] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> List["ThreadGroup"]:
        devices = list(devices) if devices is not None else ["cpu"] * size
        if len(devices) != size:
            raise ValueError(f"ThreadGroup: {len(devices)} devices for {size} ranks")
        hub = _Hub(size, timeout_s)
        return [cls(hub, r, devices, timeout_s) for r in range(size)]

    def _wait(self, what: str) -> None:
        try:
            self._hub.barrier.wait()
        except threading.BrokenBarrierError:
            raise TimeoutError(f"rank {self.rank} of {self.size}: {what} (call {self.calls}) did not complete "
                               f"within {self.timeout_s} s, or another rank failed") from None

    def all_gather(self, tensor: torch.Tensor) -> List[torch.Tensor]:
        self.calls += 1
        self.gathered_bytes += tensor.nbytes * self.size
        what = f"all_gather of {tuple(tensor.shape)} {tensor.dtype}"
        t0 = time.perf_counter()
        self._hub.slots[self.rank] = tensor
        self._wait(what)
        got = list(self._hub.slots)
        self._wait(what)  # nobody refills a slot before every rank has read them all
        for r, t in enumerate(got):
            if t.shape != tensor.shape or t.dtype != tensor.dtype:
                raise ValueError(f"rank {self.rank}: all_gather got {tuple(t.shape)} {t.dtype} from rank {r}, "
                                 f"gave {tuple(tensor.shape)} {tensor.dtype}")
        out = [t if r == self.rank else t.to(self.device, copy=True) for r, t in enumerate(got)]
        self.seconds += time.perf_counter() - t0
        return out

    def barrier(self) -> None:
        self.calls += 1
        self._wait("barrier")

    def abort(self) -> None:
        """Release every rank waiting in a collective (they raise)."""
        self._hub.barrier.abort()


def run_threads(groups: Sequence[ThreadGroup], fn: Callable, *args, **kwargs) -> list:
    """fn(group, *args, **kwargs) in one thread a rank; the results in rank
    order. The first rank to raise aborts the others' collectives, and its
    error is raised here."""
    results: list = [None] * len(groups)
    errors: list = [None] * len(groups)

    def body(r):
        try:
            results[r] = fn(groups[r], *args, **kwargs)
        except BaseException as e:  # noqa: BLE001  (re-raised below, in the caller's thread)
            errors[r] = e
            groups[r].abort()

    threads = [threading.Thread(target=body, args=(r,), name=f"rank{r}") for r in range(len(groups))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    first = next((e for e in errors if e is not None and not isinstance(e, TimeoutError)), None)
    first = first or next((e for e in errors if e is not None), None)
    if first is not None:
        raise first
    return results


class TorchGroup(Group):
    """This process's rank of a `torch.distributed` group (see `initialize`)."""

    def __init__(self, rank: int, size: int, backend: str, device, timeout_s: float):
        self.rank, self.size, self.backend = rank, size, backend
        self.timeout_s = timeout_s
        kind = torch.device(device).type
        self.devices = tuple(rank_device(r, kind) for r in range(size))
        self.device = self.devices[rank]

    def _run(self, what: str, fn):
        self.calls += 1
        try:
            return fn()
        except Exception as e:  # noqa: BLE001  (re-raised with the rank and the call)
            raise RuntimeError(f"rank {self.rank} of {self.size} ({self.backend}): {what} (call {self.calls}) "
                               f"failed: {e}") from e

    def all_gather(self, tensor: torch.Tensor) -> List[torch.Tensor]:
        import torch.distributed as dist

        data = _as_bytes(tensor)
        if self.backend == "nccl" and not data.is_cuda:
            raise ValueError(f"rank {self.rank}: nccl all_gather needs a CUDA tensor, got one on {tensor.device}")
        if self.backend == "gloo" and data.is_cuda:
            # the staging below waits for the card's queued work anyway:
            # wait first, so that `seconds` holds the exchange alone
            torch.cuda.current_stream(data.device).synchronize()
        t0 = time.perf_counter()
        if self.backend == "gloo":
            data = data.cpu()  # gloo reduces host memory: a CUDA tensor goes through the host
        outs = [torch.empty_like(data) for _ in range(self.size)]
        self.gathered_bytes += data.nbytes * self.size
        self._run(f"all_gather of {tuple(tensor.shape)} {tensor.dtype}", lambda: dist.all_gather(outs, data))
        out = [_from_bytes(o.to(tensor.device), tensor) for o in outs]
        self.seconds += time.perf_counter() - t0  # on nccl: the host's time to queue the exchange
        return out

    def barrier(self) -> None:
        import torch.distributed as dist

        if self.backend == "nccl":
            self._run("barrier", lambda: dist.barrier(device_ids=[self.device.index]))
        else:
            self._run("barrier", dist.barrier)

    def destroy(self) -> None:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def initialize(rank: int, world_size: int, init_method: str, backend: str = "gloo",
               timeout: float = DEFAULT_TIMEOUT_S, device="cuda") -> TorchGroup:
    """Join the group of `world_size` ranks as `rank` (the counterpart of
    `jax.distributed.initialize`). init_method: a `file://` path every rank
    names alike; backend "gloo" or "nccl";
    device "cuda" (rank r on cuda:(r % visible cards)) or "cpu" (gloo only).
    NCCL takes one rank a card: it raises before init when two ranks would
    share one."""
    import torch.distributed as dist

    if backend not in ("gloo", "nccl"):
        raise ValueError(f"initialize: backend must be 'gloo' or 'nccl', got {backend!r}")
    if not 0 <= rank < world_size:
        raise ValueError(f"initialize: rank {rank} outside a world of {world_size}")
    if backend == "nccl":
        if torch.device(device).type != "cuda":
            raise ValueError("initialize: nccl runs on CUDA devices only; use backend='gloo' for the CPU")
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: nccl needs a GPU and none is visible")
        cards = torch.cuda.device_count()
        if world_size > cards:
            raise ValueError(f"initialize: nccl takes one rank a card, and {world_size} ranks map to "
                             f"{cards} visible card(s) (rank {cards} shares cuda:0 with rank 0); "
                             f"use backend='gloo' to put several ranks on one card")
    group = TorchGroup(rank, world_size, backend, device, timeout)
    if group.device.type == "cuda":
        torch.cuda.set_device(group.device)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    return group
