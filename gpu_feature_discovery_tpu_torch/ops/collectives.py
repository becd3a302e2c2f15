"""Device meshes and the collectives over them (no twin module: what XLA
inserted for ``gpu_feature_discovery_tpu/ops/healthcheck.py`` from
``shard_map``, ``psum``, ``ppermute`` and ``NamedSharding``).

The twin keeps its parallelism inside one process: one JAX process holds
every local chip and the collectives run over a named mesh. This port
keeps that shape. One process holds every local GPU, a sharded value is a
list of per-device tensors in the mesh's row-major order, and

- ``all_reduce`` sums such a list. Over one device the sum is that
  device's own value, as the twin's ``psum`` over a one-chip mesh is (XLA
  builds no collective for one participant): a copy, with no NCCL.
  Over several CUDA devices it is single-process multi-device NCCL
  (``nccl_all_reduce`` over ``torch.cuda.nccl``): one communicator per
  device tuple, cached by torch, so the first call pays its set-up;
- ``ring_shift`` moves each entry to the next device of its group with a
  peer copy (``Tensor.to``), the twin's ``ppermute`` ring;
- ``RowParallelSum`` and ``DataParallelGrad`` are the two seams of a
  Megatron train step, as autograd functions: ``torch.cuda.nccl`` is not
  autograd-aware.

On a list of several CPU tensors (the tests, ``TFD_BURNIN_ALLOW_CPU``)
the sum is the plain host sum; the same CPU device may stand for every
mesh position, as the twin's virtual CPU devices do. A list of several
CUDA tensors never falls back to the host: without NCCL, or with a
device listed twice, it raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


class Mesh:
    """A named device mesh: ``devices`` is a numpy object array of
    ``torch.device`` whose axes are ``axis_names``, in the row-major order
    of ``jax.sharding.Mesh``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        given = np.asarray(devices, dtype=object)
        self.devices = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(given.shape):
            self.devices[idx] = torch.device(given[idx])
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"mesh of shape {self.devices.shape} needs "
                f"{self.devices.ndim} axis names, got {self.axis_names}"
            )

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat_devices(self) -> List[torch.device]:
        """The devices in row-major order: position i holds shard i."""
        return list(self.devices.flat)


def axis_groups(mesh: Mesh, axis: str) -> List[List[int]]:
    """The device groups along ``axis``: one group per position of the
    other axes, each the flat row-major indices of the devices that differ
    only in their ``axis`` coordinate, ordered by it. On a (data=4,
    model=2) mesh, ``"model"`` gives [[0, 1], [2, 3], [4, 5], [6, 7]] and
    ``"data"`` gives [[0, 2, 4, 6], [1, 3, 5, 7]]."""
    pos = mesh.axis_names.index(axis)
    index = np.arange(mesh.size).reshape(mesh.devices.shape)
    moved = np.moveaxis(index, pos, -1)
    return [list(map(int, row)) for row in moved.reshape(-1, moved.shape[-1])]


def _check_cuda_list(tensors: Sequence[torch.Tensor]) -> None:
    indices = [t.device.index for t in tensors]
    if len(set(indices)) != len(indices):
        raise ValueError(f"NCCL needs one tensor per CUDA device, got devices {indices}")
    import torch.cuda.nccl as nccl

    if not nccl.is_available(list(tensors)):
        raise RuntimeError(
            "torch.cuda.nccl cannot reduce these tensors: this torch has no "
            "NCCL, or a tensor is sparse or not contiguous"
        )


def all_reduce(
    tensors: Sequence[torch.Tensor], out: Optional[Sequence[torch.Tensor]] = None
) -> List[torch.Tensor]:
    """Sum same-shape tensors, one per mesh device, into every device's
    entry; returns the summed list (``out`` when given, else new
    tensors). The inputs are left as they are.

    One tensor is copied into its ``out``, on any device. Several CUDA
    tensors go to ``nccl_all_reduce``, which does not wait for the
    devices; several CPU tensors are summed on the host. A list mixing
    the two raises."""
    tensors = list(tensors)
    if not tensors:
        raise ValueError("all_reduce of an empty list")
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1 or kinds - {"cuda", "cpu"}:
        raise ValueError(f"all_reduce over devices of kinds {sorted(kinds)}")
    if any(t.shape != tensors[0].shape or t.dtype != tensors[0].dtype for t in tensors):
        raise ValueError("all_reduce needs tensors of one shape and dtype")
    if out is None:
        out = [torch.empty_like(t, memory_format=torch.contiguous_format) for t in tensors]
    out = list(out)
    if len(tensors) == 1:
        out[0].copy_(tensors[0])
        return out
    if kinds == {"cpu"}:
        total = torch.stack(tensors).sum(0, dtype=tensors[0].dtype)
        for o in out:
            o.copy_(total)
        return out
    return nccl_all_reduce(tensors, out)


def nccl_all_reduce(tensors: Sequence[torch.Tensor], out: Sequence[torch.Tensor]) -> list:
    """``torch.cuda.nccl.all_reduce`` of CUDA tensors, one per device, into
    ``out`` on each device's current stream; returns ``out``. The first
    call over a device tuple builds its communicator."""
    _check_cuda_list(tensors)
    import torch.cuda.nccl as nccl

    out = list(out)
    nccl.all_reduce(list(tensors), out)
    return out


def _ring_perm(size: int) -> list:
    """The twin's ``ppermute`` ring: (source, destination) pairs."""
    return [(i, (i + 1) % size) for i in range(size)]


def ring_shift(tensors: Sequence[torch.Tensor], group: Sequence[torch.device]) -> list:
    """Send entry i to ``group[(i + 1) % len]`` with a peer copy; returns
    the received list, entry j on ``group[j]`` holding what its left
    neighbour sent. ``Tensor.to`` copies peer to peer where the devices
    have peer access and through the host otherwise; the caller checks
    the values, not the route."""
    received = [None] * len(tensors)
    for src, dst in _ring_perm(len(tensors)):
        received[dst] = tensors[src].to(group[dst])
    return received


class RowParallelSum(torch.autograd.Function):
    """The row-parallel seam: sums the partial outputs of the model-axis
    group in forward (one entry per device), and passes each device's
    gradient through unchanged in backward.

    Why the identity is the right conjugate: every device of the group
    computes the loss on the SAME summed output, and the train step seeds
    backward with each device's own loss, so the objective autograd
    differentiates is M copies of the true loss L, M the group's size.
    The exact transpose of the sum sends sum_m g_m = M * g to every
    partial, g = dL/d(out) being equal on every device; dividing by the M
    copies leaves g, which is what the identity passes. The twin's XLA
    psum seam gives the same dL/d(partial)."""

    @staticmethod
    def forward(ctx, *partials):
        return tuple(all_reduce(partials))

    @staticmethod
    def backward(ctx, *grads):
        return grads


class DataParallelGrad(torch.autograd.Function):
    """The data-parallel replica seam: identity in forward over the
    replicas of one weight shard (one per data-axis device), all-reduce of
    their gradients in backward.

    The replicas are one variable w. Each device's loss term L_d covers
    only its rows of the batch, scaled by the global batch, so L = sum_d
    L_d and dL/dw = sum_d dL_d/dw: the sum of what each replica receives,
    delivered to every replica. That keeps them equal after the update,
    as the twin's replicated weight is one array."""

    @staticmethod
    def forward(ctx, *replicas):
        return tuple(r.view_as(r) for r in replicas)

    @staticmethod
    def backward(ctx, *grads):
        return tuple(all_reduce([g.contiguous() for g in grads]))
