"""Ranks, their process group, and meshes over them.

The port's counterpart of :mod:`repro.launch.mesh`.  JAX runs one process
over every device of a host; here each rank is a process, and
:func:`init_ranks` joins it to the group before any mesh exists:

- ``nccl`` when every rank of the host has a card of its own;
- ``gloo`` on the CPU, or when ranks share a card (NCCL refuses two ranks
  on one GPU; gloo takes CUDA tensors for ``all_reduce``, ``broadcast``,
  ``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
  ``all_to_all_single``, staging them through the host, but not for
  ``send`` / ``recv``).  In the card's PyTorch 2.11 the functional
  all-gather (``_c10d_functional.all_gather_into_tensor``, which
  DTensor's gathers call) dies with SIGSEGV on CUDA tensors under gloo,
  where c10d's own ``all_gather_into_tensor`` runs:
  :func:`route_functional_all_gather` sends the first to the second, and
  :func:`init_ranks` installs it for gloo ranks on a card.

A backend that was asked for and fails raises; nothing falls back to
another one.  :func:`spawn_ranks` starts a group of ranks on this host
(``spawn``, so a parent that has touched CUDA can start them), with a
timeout on every join; ``python -m torch.distributed.run`` starts them from
the shell.
"""

from __future__ import annotations

import datetime
import logging
import os
import pickle
import socket
import tempfile
import time
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.compat import make_auto_mesh

logger = logging.getLogger("repro_torch.launch")

DEFAULT_TIMEOUT_S = 600.0


class Ranks(NamedTuple):
    """What :func:`init_ranks` set up for this process."""

    rank: int
    world_size: int
    local_rank: int
    backend: str
    device: torch.device


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    return default if raw in (None, "") else int(raw)


def free_port() -> int:
    """A TCP port on ``localhost`` that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_ranks(backend: str | None = None, *, device=None,
               init_method: str | None = None, rank: int | None = None,
               world_size: int | None = None,
               local_rank: int | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> Ranks:
    """Join this process to the default process group.

    ``rank`` / ``world_size`` / ``local_rank`` default to the ``RANK`` /
    ``WORLD_SIZE`` / ``LOCAL_RANK`` variables ``torch.distributed.run``
    sets (else rank 0 of 1); ``init_method`` to ``env://`` when
    ``MASTER_ADDR`` is set, else, for a world of one, a free port on
    ``localhost``.  ``device`` is where the rank keeps its tensors:
    ``cuda`` (the default; the card ``local_rank`` modulo the card count
    becomes the current device) or ``cpu``.  ``backend=None`` takes
    ``nccl`` when every rank of the host (``LOCAL_WORLD_SIZE``) has a card
    of its own, else ``gloo``, and logs the choice.  ``timeout_s`` bounds
    every collective: a rank that goes its own way fails the group instead
    of hanging it.
    """
    dev = torch.device("cuda" if device is None else device)
    rank = _env_int("RANK", 0) if rank is None else rank
    world_size = _env_int("WORLD_SIZE", 1) if world_size is None \
        else world_size
    local_rank = _env_int("LOCAL_RANK", rank) if local_rank is None \
        else local_rank
    local_world = _env_int("LOCAL_WORLD_SIZE", world_size)
    own_card = False
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_ranks: no CUDA device is available; pass "
                "device='cpu' to run the ranks on the CPU")
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
        own_card = n_cards >= local_world
    if backend is None:
        backend = "nccl" if own_card else "gloo"
        why = ("each rank has a card of its own" if own_card else
               "ranks on the CPU" if dev.type == "cpu" else
               f"{local_world} ranks share {torch.cuda.device_count()} "
               f"card(s)")
    else:
        why = "asked for"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs device='cuda'")
    if init_method is None:
        if os.environ.get("MASTER_ADDR"):
            init_method = "env://"
        elif world_size == 1:
            init_method = f"tcp://localhost:{free_port()}"
        else:
            raise ValueError(
                "init_ranks: a world of several ranks needs init_method "
                "or the MASTER_ADDR / MASTER_PORT variables")
    logger.info("init_ranks: rank %d of %d on %s, backend %s (%s)", rank,
                world_size, dev, backend, why)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "gloo" and dev.type == "cuda":
        route_functional_all_gather("CUDA")
    return Ranks(rank, world_size, local_rank, backend, dev)


_ROUTED = {}


def route_functional_all_gather(dispatch_key: str) -> None:
    """Run ``_c10d_functional.all_gather_into_tensor`` on ``dispatch_key``
    tensors through c10d's ``all_gather_into_tensor`` on the resolved
    group (synchronously: the result is complete when it returns, and the
    functional ``wait_tensor`` finds no work to wait for).  For a world of
    gloo ranks on a card (see the module docstring); once a process."""
    if dispatch_key in _ROUTED:
        return
    from torch.distributed.distributed_c10d import _resolve_process_group

    def all_gather_into_tensor(inp, group_size, group_name):
        out = inp.new_empty((inp.shape[0] * group_size, *inp.shape[1:]))
        dist.all_gather_into_tensor(
            out, inp.contiguous(), group=_resolve_process_group(group_name))
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", all_gather_into_tensor, dispatch_key)
    _ROUTED[dispatch_key] = lib


def close_ranks() -> None:
    """Leave the default process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(i, fn, world_size, port, device, backend, timeout_s, args,
               out_dir):
    if torch.device(device).type == "cpu":
        # one thread a rank, as torch.distributed.run sets by default: the
        # ranks share the host's cores with each other and with the caller
        torch.set_num_threads(1)
    init_ranks(backend, device=device,
               init_method=f"tcp://localhost:{port}", rank=i,
               world_size=world_size, local_rank=i, timeout_s=timeout_s)
    try:
        result = fn(*args)
    finally:
        close_ranks()
    with open(os.path.join(out_dir, f"rank{i}.pkl"), "wb") as fh:
        pickle.dump(result, fh)


def spawn_ranks(fn, world_size: int, args: tuple = (), *, device="cuda",
                backend: str | None = None,
                timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(*args)`` on ``world_size`` new ranks of one group on this
    host and return their results, in rank order.

    Each rank is a process started with ``spawn``, joined by
    :func:`init_ranks` (``device``: ``cuda``, the default, or ``cpu``;
    ``backend``; on the CPU one thread a rank) over a free ``localhost``
    port.  Ranks on the card load the kernels this process builds before
    it starts them, so that they do not each compile them.
    ``fn`` must be importable by name, and its result picklable: return
    host data (numpy arrays, numbers), not device tensors.  A rank that
    raises or dies fails the call, and the others are stopped; so are all
    of them when the group has not finished within ``timeout_s``.
    """
    import torch.multiprocessing as mp

    if torch.device(device).type == "cuda":
        from repro_torch.kernels import _build

        _build.build_all()
    port = free_port()
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(
            _rank_main,
            args=(fn, world_size, port, device, backend, timeout_s, args,
                  out_dir),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(),
                                           0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"spawn_ranks: {world_size} ranks of "
                        f"{getattr(fn, '__name__', fn)} not done within "
                        f"{timeout_s:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        results = []
        for i in range(world_size):
            with open(os.path.join(out_dir, f"rank{i}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
    return results


def init_fake_world(world_size: int, rank: int = 0):
    """Join this process, as ``rank``, to a fake world of ``world_size``
    ranks in one process (PyTorch's ``fake`` backend): collectives return
    at once and move nothing, so a step traced under ``FakeTensorMode``
    over a mesh of the world allocates nothing and talks to no one.  The
    dry run's world (:mod:`repro_torch.launch.dryrun`)."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "init_fake_world: this PyTorch has no fake process group "
            "(torch.testing._internal.distributed.fake_pg): the dry run "
            "needs it") from e
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    return Ranks(rank, world_size, rank, "fake", torch.device("cpu"))


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """The reference's production mesh over the world: one pod (16 x 16
    over ``("data", "model")``, 256 ranks) or two (2 x 16 x 16 over
    ``("pod", "data", "model")``, 512).  It needs a world of that size:
    the dry run's fake one (:func:`init_fake_world`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_auto_mesh(shape, axes, device_type)


def make_rank_mesh(device_type=None):
    """Every rank of the world on the ``data`` dimension, ``(W, 1)`` over
    ``("data", "model")``: the mesh of one host of cards, over which the
    column-distributed greedy shards S."""
    w = dist.get_world_size()
    return make_auto_mesh((w, 1), ("data", "model"), device_type)


def make_host_mesh(n: int | None = None, axes=("data", "model"),
                   device_type=None):
    """A small mesh over the first ``n`` ranks (default: the world), as
    the reference's: ``(n,)`` for one axis, else ``(2, n // 2)`` (``(1,
    n)`` for odd ``n``)."""
    n = n or dist.get_world_size()
    if len(axes) == 1:
        shape = (n,)
    else:
        a = 2 if n % 2 == 0 and n > 1 else 1
        shape = (a, n // a)
    return make_auto_mesh(shape, axes, device_type)


def _dim(mesh, name: str) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    return mesh.size(names.index(name)) if name in names else 1


def dp_size(mesh) -> int:
    return _dim(mesh, "pod") * _dim(mesh, "data")


def tp_size(mesh) -> int:
    return _dim(mesh, "model")
