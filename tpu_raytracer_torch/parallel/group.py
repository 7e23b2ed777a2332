"""Process groups of the multi-device renders, on ``torch.distributed``.

Counterpart of ``make_mesh`` in ``tpu_raytracer/parallel/sharding.py``. A
JAX mesh is one program over many devices; here every rank is a process
of its own, and a ``Group`` is what a rank knows of the others: its
rank, the world size, its ``torch.device``, the collective backend and
the process group the collectives run in.

  * ``make_group()`` reads a default group that is already initialised,
    as under ``torchrun``.
  * ``spawn(fn, world_size, ...)`` starts the ranks itself with
    ``torch.multiprocessing`` (spawn context), joins them through a
    ``file://`` store in a temporary directory (no TCP port to collide
    with another job's), runs ``fn(group, *args)`` on each rank and
    returns each rank's result. ``fn`` is pickled by its import path, so
    it must be a module-level function; ``PerRank(items)`` in ``args``
    hands rank i ``items[i]`` alone.

Devices: ``cuda:{rank}`` unless the caller names one device for every
rank (``device="cpu"``, or ``"cuda:0"`` to put every rank on one card).
The backend defaults to ``nccl`` on CUDA devices and ``gloo`` on the
CPU, and is never switched: NCCL refuses two ranks on one card, so ranks
sharing a card take ``backend="gloo"``, and ``nccl`` with two ranks on
one device raises.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
import traceback

import torch
import torch.distributed as dist

# How long a collective may wait for the other ranks before it raises.
TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True)
class Group:
    """One rank's view of a process group: ``rank`` in ``[0,
    world_size)``, its ``device``, the ``backend`` (``nccl`` or ``gloo``)
    and ``pg``, the process group (None: the default group)."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    pg: object = None

    def first(self, size: int) -> "Group | None":
        """Ranks 0 to ``size - 1`` of the default group as a group of
        their own: its ``Group`` on those ranks, None on the others. Every
        rank of the default group must call it with the same ``size``
        (``torch.distributed.new_group``)."""
        if self.pg is not None:
            raise ValueError("first() subdivides the default group only")
        if not 1 <= size <= self.world_size:
            raise ValueError(f"cannot take {size} of {self.world_size} ranks")
        if size == self.world_size:
            return self
        pg = dist.new_group(list(range(size)), backend=self.backend)
        if self.rank >= size:
            return None
        return Group(rank=self.rank, world_size=size, device=self.device,
                     backend=self.backend, pg=pg)


def default_device(rank: int, device=None) -> torch.device:
    """``device`` for every rank where given, else ``cuda:{rank}``."""
    return torch.device(device) if device is not None else torch.device("cuda", rank)


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def check_backend(backend: str, devices: list[torch.device]) -> None:
    """Raise where ``backend`` cannot serve ranks on ``devices``: NCCL
    takes CUDA devices only, one rank per device."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}; nccl or gloo")
    if backend == "nccl":
        if any(d.type != "cuda" for d in devices):
            raise ValueError("nccl needs every rank on a CUDA device")
        if len({d.index for d in devices}) != len(devices):
            raise ValueError("nccl refuses two ranks on one CUDA device; "
                             "ranks that share a card take backend='gloo'")


def make_group(device=None) -> Group:
    """The ``Group`` of the initialised default process group (as
    ``torchrun`` and ``init_process_group`` leave it); the rank's device is
    ``device`` or ``cuda:{rank}``."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised; call "
                           "init_process_group first (or run under torchrun)")
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = default_device(rank, device)
    backend = dist.get_backend()
    if backend == "nccl":
        devices = [None] * world
        dist.all_gather_object(devices, str(dev))
        check_backend(backend, [torch.device(d) for d in devices])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Group(rank=rank, world_size=world, device=dev, backend=backend)


@dataclasses.dataclass(frozen=True)
class PerRank:
    """A ``spawn`` argument that differs between ranks: rank i receives
    ``items[i]`` (None past the end) and no other rank's item."""

    items: tuple


def _for_rank(x, rank: int):
    if isinstance(x, PerRank):
        return x.items[rank] if rank < len(x.items) else None
    if isinstance(x, tuple) and not hasattr(x, "_fields"):
        return tuple(_for_rank(v, rank) for v in x)
    if isinstance(x, list):
        return [_for_rank(v, rank) for v in x]
    if isinstance(x, dict):
        return {k: _for_rank(v, rank) for k, v in x.items()}
    return x


def to_host(x):
    """``x`` with every tensor in it (through tuples, lists, dicts and
    named tuples) moved to the CPU."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_host(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    return x


def to_device(x, device):
    """``x`` with every tensor and every object with a ``to(device)``
    method (``SceneTensors``, ``SceneShard``) in it, through tuples, lists
    and dicts, on ``device``."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_device(v, device) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_device(v, device) for v in x)
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    return x.to(device) if callable(getattr(x, "to", None)) else x


def _worker(rank: int, world_size: int, workdir: str, devices: list, backend: str) -> None:
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)  # the ranks share the host's cores
    out = os.path.join(workdir, f"result{rank}.pkl")
    try:
        with open(os.path.join(workdir, f"payload{rank}.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        dist.init_process_group(backend, init_method="file://" + os.path.join(workdir, "store"),
                                rank=rank, world_size=world_size,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            group = Group(rank=rank, world_size=world_size, device=dev, backend=backend)
            result = to_host(fn(group, *args))
        finally:
            from ..render.pipeline import clear_compiled

            # compiled entries hold their group's process group: drop them
            # while it lives, not at interpreter exit
            clear_compiled()
            dist.destroy_process_group()
        with open(out, "wb") as f:
            pickle.dump(("ok", result), f)
    except BaseException:
        with open(out, "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        raise


def spawn(fn, world_size: int, args: tuple = (), device=None, backend: str | None = None) -> list:
    """Run ``fn(group, *args)`` on ``world_size`` new ranks and return
    their results, rank 0 first, with every tensor moved to the CPU.

    ``device``: one device for every rank (``"cpu"``, ``"cuda:0"``), else
    ``cuda:{rank}``. ``backend``: ``nccl`` or ``gloo`` (default: ``nccl``
    on CUDA devices, ``gloo`` on the CPU). Ranks on the CPU compute on one
    thread each. A rank that raises makes ``spawn`` raise with that rank's
    traceback, after every rank has ended."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    devices = [default_device(r, device) for r in range(world_size)]
    backend = backend or default_backend(devices[0])
    check_backend(backend, devices)
    workdir = tempfile.mkdtemp(prefix="trt_spawn_")
    try:
        for r in range(world_size):
            with open(os.path.join(workdir, f"payload{r}.pkl"), "wb") as f:
                pickle.dump((fn, _for_rank(args, r)), f, protocol=pickle.HIGHEST_PROTOCOL)
        failure = None
        try:
            mp.start_processes(_worker, nprocs=world_size, start_method="spawn", join=True,
                               args=(world_size, workdir, [str(d) for d in devices], backend))
        except ProcessException as e:  # a rank failed or died; the others were ended
            failure = e
        results, errors = [], []
        for r in range(world_size):
            path = os.path.join(workdir, f"result{r}.pkl")
            if not os.path.exists(path):
                errors.append(f"rank {r} left no result")
                continue
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status == "ok":
                results.append(value)
            else:
                errors.append(f"rank {r} raised:\n{value}")
        if failure is not None or errors:
            raise RuntimeError("\n".join(errors) or str(failure)) from failure
        return results
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def run_calls(group: Group, calls: list) -> list:
    """A ``spawn`` worker that runs many calls in one set of ranks: each
    ``(size, fn, args)`` of ``calls`` is ``fn(sub, *args)`` on the first
    ``size`` ranks, ``sub`` being their ``Group`` (``Group.first``), with
    ``args`` moved to the rank's device (``to_device``); the other ranks
    skip it. Returns this rank's results (None where it skipped)."""
    subs, out = {}, []
    for size, fn, args in calls:
        if size not in subs:
            subs[size] = group.first(size)
        sub = subs[size]
        out.append(None if sub is None else fn(sub, *to_device(args, sub.device)))
    return out
