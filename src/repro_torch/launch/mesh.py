"""Process groups and meshes over `torch.distributed`.

Port of `repro/launch/mesh.py` (`make_host_mesh`), with what a torch
world needs before it has a mesh: `init_world` starts or joins a world
(NCCL over CUDA cards, gloo over CPU processes) and `run_world` spawns
one. A world initializes through a `file://` store (a path every rank
can open), never through a TCP port: the machines this runs on have no
network, and parallel test workers must not collide on a port. Under
`torchrun` the world is joined through the environment it sets.

No fallback: a CUDA world needs one card a rank and raises otherwise, a
missing NCCL raises, and a world that cannot be initialized raises; none
of them drops to gloo or to the CPU. The one exception is asked for by
name: `shared_card=True` places every rank of a small world on card 0
over gloo (NCCL refuses two ranks on one card), to rehearse a model axis
on a machine with one card, as the reference rehearses on forced host
devices. Its tensors stay on the card; gloo runs `all_reduce` (SUM,
MAX), `all_gather` and `broadcast` on them through host memory
(README.md), so it measures no tensor-parallel speed.

`make_production_mesh` is the reference's production topology, a
("data", "model") mesh of 16 x 16 ranks or a ("pod", "data", "model")
one of 2 x 16 x 16, over a fake world (PyTorch's fake process-group
backend: collectives return at once and move nothing), with this process
as one rank of it: what the dry run (`launch/dryrun.py`) runs one rank's
step in, on fake tensors.
"""
from __future__ import annotations

import contextlib
import ctypes
import datetime
import math
import os
import signal
import sys
import tempfile
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.sharding import mesh_exec
from repro_torch.sharding.mesh_exec import world_device

# how long a rank waits for the others in a collective or at start-up
WORLD_TIMEOUT_S = 300.0


def under_torchrun() -> bool:
    """Whether this process is a rank that `torchrun` started."""
    return "TORCHELASTIC_RUN_ID" in os.environ and "RANK" in os.environ


def init_world(rank: int, world_size: int, store: Optional[str],
               device, shared_card: bool = False) -> torch.device:
    """Start or join a world of `world_size` ranks as `rank`, through the
    `file://` store at `store` (None: the `env://` variables `torchrun`
    sets). `device` "cuda" gives an NCCL world with rank r on card r;
    "cpu" a gloo world; "cuda" with `shared_card` a gloo world with every
    rank on card 0. Returns the rank's device. A world already
    initialized must be the one asked for."""
    dev = torch.device(device)
    if shared_card and dev.type != "cuda":
        raise ValueError("shared_card places the ranks on one CUDA card")
    if dev.type == "cuda":
        check_cards(1 if shared_card else world_size)
    if dist.is_initialized():
        if dist.get_world_size() != world_size or dist.get_rank() != rank:
            raise RuntimeError(
                f"a world of {dist.get_world_size()} ranks (this one "
                f"{dist.get_rank()}) is already initialized; asked for rank "
                f"{rank} of {world_size}")
        return torch.device("cuda", 0) if shared_card \
            else _rank_device(dev, rank)
    if shared_card:
        backend = "gloo"
    elif dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL; a CUDA world needs "
                               "it (no fallback to gloo)")
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no world over {dev.type} devices")
    dev = torch.device("cuda", 0) if shared_card else _rank_device(dev, rank)
    mesh_exec.SHARED_CARD = dev if shared_card else None
    if shared_card:
        torch.cuda.set_device(dev)
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev          # connect now: a fault shows here
    dist.init_process_group(
        backend, init_method=None if store is None else f"file://{store}",
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S), **kw)
    return dev


def check_cards(world_size: int) -> None:
    """A CUDA world needs one card a rank: raise with the count
    otherwise."""
    n = torch.cuda.device_count()
    if n < world_size:
        raise RuntimeError(
            f"a CUDA world of {world_size} ranks needs {world_size} cards, "
            f"one a rank; this machine has {n}")


def _rank_device(dev: torch.device, rank: int) -> torch.device:
    return torch.device("cuda", rank) if dev.type == "cuda" else dev


def make_host_mesh(model: int = 1):
    """A ("data", "model") `DeviceMesh` over the initialized world: the
    model axis of `model` ranks (at most the world), the data axis of
    the rest."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    model = min(int(model), n)
    if n % model:
        raise ValueError(f"a model axis of {model} does not divide the "
                         f"world of {n} ranks")
    return init_device_mesh(world_device().type, (n // model, model),
                            mesh_dim_names=("data", "model"))


# the reference's production meshes (`repro/launch/mesh.py`): one pod of
# 16 x 16, or two
PRODUCTION_MESHES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


@contextlib.contextmanager
def fake_mesh(shape: Sequence[int], names: Sequence[str], *, rank: int = 0,
              device=None):
    """A `DeviceMesh` of `shape` over a fake world of prod(shape) ranks,
    this process being `rank`, on `device` (CUDA unless named). The world
    is destroyed on exit. Refuses to start while a world is initialized:
    the fake one would replace it."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("a world is already initialized; a fake world "
                           "runs only in a process without one")
    n = math.prod(shape)
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a world of {n}")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
    try:
        yield init_device_mesh(dev.type, tuple(shape),
                               mesh_dim_names=tuple(names))
    finally:
        dist.destroy_process_group()


def make_production_mesh(multi_pod: bool = False, *, rank: int = 0,
                         device=None):
    """The production mesh (`PRODUCTION_MESHES`) over a fake world, as a
    context manager yielding the `DeviceMesh` of rank `rank`."""
    shape, names = PRODUCTION_MESHES[bool(multi_pod)]
    return fake_mesh(shape, names, rank=rank, device=device)


def _die_with_parent() -> None:
    """Have the kernel end this process when the process that spawned it
    ends (Linux), so a cut run leaves no rank behind."""
    if sys.platform.startswith("linux"):
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, signal.SIGKILL)        # PR_SET_PDEATHSIG


def _rank_main(rank, fn, world_size, store, device, threads, shared_card,
               args):
    _die_with_parent()
    if threads:
        torch.set_num_threads(threads)
    init_world(rank, world_size, store, device, shared_card)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_world(fn: Callable, world_size: int, *args, device="cuda",
              timeout_s: Optional[float] = None, threads: int = 0,
              store_dir: Optional[str] = None,
              shared_card: bool = False) -> None:
    """Spawn `world_size` ranks, each running `fn(rank, *args)` in a world
    initialized by `init_world` (`fn` and `args` must pickle: `fn` a
    module-level function). Raises if a rank fails (the others are
    ended) or, with `timeout_s`, when the ranks have not all finished in
    time (every rank is killed). `threads` > 0 sets each rank's torch
    intra-op threads. The `file://` store lives in `store_dir` (a fresh
    temporary directory by default). `shared_card` puts every rank on
    card 0 over gloo (`init_world`)."""
    import torch.multiprocessing as mp
    if torch.device(device).type == "cuda":
        check_cards(1 if shared_card else world_size)  # before any rank
    elif shared_card:
        raise ValueError("shared_card places the ranks on one CUDA card")
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        store = str(Path(tmp) / "store")
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, store, device, threads,
                              shared_card, args),
            nprocs=world_size, join=False, start_method="spawn")
        try:
            if timeout_s is None:
                while not ctx.join():
                    pass
                return
            deadline = datetime.datetime.now() + datetime.timedelta(
                seconds=timeout_s)
            while not ctx.join(timeout=1.0):
                if datetime.datetime.now() > deadline:
                    raise TimeoutError(f"a world of {world_size} ranks did "
                                       f"not finish in {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
