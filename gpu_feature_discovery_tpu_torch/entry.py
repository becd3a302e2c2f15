"""Driver entry points: the one-device burn-in step and the multi-device
dry run (twin: ``__graft_entry__.py`` at the JAX package's root).

``entry`` exposes the flagship on-device workload, the burn-in step the
health labeler runs (ops/healthcheck.py); ``dryrun_multichip`` runs the
whole slice-validation path — the DP+TP train step and the ring sweep —
over an n-device mesh. Both run on CUDA devices unless the caller passes
others. The twin's respawn into a fresh interpreter has no counterpart:
it exists only because JAX cannot switch platforms once initialised.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from gpu_feature_discovery_tpu_torch.ops import healthcheck


def entry(device=None):
    """Return ``(fn, example_args)``: the burn-in step and its inputs at
    the twin's ``make_burnin_step`` defaults (512 wide, 8 deep, bf16) on
    ``device`` (default ``cuda:0``)."""
    if device is None:
        device = torch.device("cuda", 0)
    args = healthcheck._burnin_input_arrays(
        healthcheck.DEFAULT_PROBE_SIZE, healthcheck.DEFAULT_PROBE_DEPTH,
        healthcheck.PROBE_DTYPE, torch.device(device),
    )
    return healthcheck.burnin_step, args


def dryrun_multichip(n_devices: int, devices: Optional[list] = None) -> None:
    """Build an n-device (data, model) mesh over ``devices`` (default the
    first n CUDA devices), run one train step on the twin's tiny shapes,
    then the ring sweep; raises AssertionError when the loss is not
    finite or a verdict fails."""
    mesh = healthcheck.build_mesh(n_devices, devices)
    step, (params, x, y) = healthcheck.make_slice_train_step(mesh)
    _, loss = step(params, x, y)
    if not math.isfinite(float(loss)):
        raise AssertionError(f"train-step loss is not finite: {float(loss)}")
    sweep = healthcheck.ici_ring_sweep(mesh)
    if not sweep["links_ok"]:
        raise AssertionError(f"ring sweep failed: {sweep}")
    if not sweep["allreduce_ok"]:
        raise AssertionError(f"all-reduce check failed: {sweep}")
