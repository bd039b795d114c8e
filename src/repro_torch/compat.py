"""Mesh construction over ``torch.distributed``.

The port's counterpart of :mod:`repro.compat`: :func:`make_auto_mesh`
builds a :class:`torch.distributed.device_mesh.DeviceMesh` of the given
shape and dimension names over the ranks of the initialised process group
(:func:`repro_torch.launch.mesh.init_ranks` initialises it).  Every rank of
the mesh calls it, in the same order, as it does every collective.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def make_auto_mesh(shape: Sequence[int], axis_names: Sequence[str],
                   device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` named ``axis_names`` over ranks
    ``0 .. prod(shape) - 1``, row-major.

    ``device_type`` is where the mesh's ranks keep their tensors:
    ``"cuda"`` or ``"cpu"``; ``None`` takes ``"cuda"`` under the NCCL
    backend and on a machine with a card, else ``"cpu"``.  Needs an
    initialised process group.
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_auto_mesh needs an initialised process group: call "
            "repro_torch.launch.mesh.init_ranks() first")
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} "
                         f"differ in length")
    if device_type is None:
        device_type = ("cuda" if dist.get_backend() == "nccl"
                       or torch.cuda.is_available() else "cpu")
    return init_device_mesh(device_type, shape, mesh_dim_names=axis_names)
