"""Carry the JAX package's probe inputs across to this port (no twin: the
bridge the parity tests use to give both packages identical inputs).

The inputs arrive as numpy arrays (``np.asarray(jax_array)``). numpy has
no bfloat16: a JAX bf16 array comes out as an ``ml_dtypes.bfloat16``
array, which ``torch.from_numpy`` refuses, so bf16 crosses as its raw 16
bits (``.view(np.uint16)``) and is reinterpreted as ``torch.bfloat16``.
"""

from __future__ import annotations

import numpy as np
import torch

from gpu_feature_discovery_tpu_torch.ops.healthcheck import (
    gather_slice_params,
    shard_slice_batch,
    shard_slice_params,
)


def _tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def burnin_inputs_from_numpy(x, ws, device) -> tuple:
    """The twin's ``_burnin_input_arrays`` output (x: (size, size), ws:
    (depth, size, size)) as tensors on ``device``, dtype kept."""
    return _tensor_from_numpy(x, device), _tensor_from_numpy(ws, device)


def stream_buffer_from_numpy(buf, device) -> torch.Tensor:
    """A (rows, 128) f32 stream buffer as a contiguous tensor on ``device``."""
    return _tensor_from_numpy(np.asarray(buf, dtype=np.float32), device)


def slice_params_from_numpy(params, mesh) -> dict:
    """The twin's slice-step ``{"w1", "w2"}`` (whole arrays, e.g.
    ``np.asarray`` of its sharded ones) as this port's per-device shards
    over ``mesh`` (``healthcheck.shard_slice_params``)."""
    whole = {k: _tensor_from_numpy(params[k], "cpu") for k in ("w1", "w2")}
    return shard_slice_params(whole, mesh)


def slice_batch_from_numpy(x, y, mesh) -> tuple:
    """The twin's slice-step batch (whole (batch, d_model) x and y) as
    per-device row shards over ``mesh``: ``(x_shards, y_shards)``."""
    return shard_slice_batch(
        _tensor_from_numpy(x, "cpu"), _tensor_from_numpy(y, "cpu"), mesh
    )


def slice_params_to_numpy(params, mesh) -> dict:
    """The per-device shards gathered back into whole numpy ``w1`` and
    ``w2``, for comparison with the twin; replicas that differ raise."""
    return {k: v.numpy() for k, v in gather_slice_params(params, mesh).items()}
