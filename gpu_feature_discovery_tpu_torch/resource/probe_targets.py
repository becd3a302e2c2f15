"""Which process probes which device, and which label index each device's
verdict carries, on a node with GPUs in MIG mode.

The twin probes every chip of its inventory and publishes ``chip.<i>.*``
for each (its verdict is ``all()`` over them, its rates the worst chip's).
CUDA shows a process that was not pinned at most ONE MIG device, so on a
MIG node the classic probe (one process, the devices CUDA lists) cannot
reach the inventory's devices. Here the node splits into:

- the plain GPUs (MIG off), which the classic probe measures, joined to
  NVML's index by UUID as on any node;
- one target per MIG device, keyed by its NVML ``MIG-`` UUID, which a
  one-shot child pinned by ``CUDA_VISIBLE_DEVICES=<that UUID>`` measures
  alone.

The label index ``i`` of ``chip.<i>.*`` counts what the strategy's
``gpu.count`` counts (lm/topology_strategy.py), so ``chips.healthy +
chips.sick == gpu.count``:

- ``none``, ``mixed``: NVML's GPUs. A MIG-enabled GPU's verdict is the
  ``all()`` of its MIG devices' verdicts; its rates are not published (a
  MIG device's rate is not its GPU's). A MIG-enabled GPU with no MIG
  device has nothing to probe and counts as neither healthy nor sick
  (the reference's ``mixed`` ignores it too).
- ``single``, valid: the MIG devices in NVML order (GPU index, then MIG
  slot), each with its own verdict and rates.
- ``single``, INVALID (``gpu.count=0``): no per-device label.
- Any strategy, a device whose probe could not get device memory (busy:
  a workload holds it), or plain GPUs that CUDA does not list: that
  device's verdict is unknown, so no verdict speaks for the node that
  round. No health label is published, the cached labels are dropped and
  the round's fault shots given back; a busy device never counts as
  sick, so it never reaches ``chips.sick``, ``slice.sick-chips`` or
  cordon advice.

A node with no GPU in MIG mode has no targets (``probe_targets`` returns
None) and keeps the classic probe alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Tuple

from gpu_feature_discovery_tpu_torch.config.spec import (
    TOPOLOGY_STRATEGY_NONE,
    TOPOLOGY_STRATEGY_SINGLE,
)
from gpu_feature_discovery_tpu_torch.resource.types import Manager
from gpu_feature_discovery_tpu_torch.topology.slice_info import SliceInfo

Shots = Tuple[FrozenSet[int], FrozenSet[int]]


@dataclass(frozen=True)
class MigTarget:
    """One MIG device to probe: its UUID (what pins its worker), its
    parent GPU's NVML index, its position among that GPU's MIG devices
    (``slot``, in NVML's slot order), and the label index its verdict
    counts toward."""

    uuid: str
    gpu: int
    slot: int
    index: int

    @property
    def key(self) -> str:
        """The worker's key: unique per device even where two devices
        share a UUID (a stand-in naming one card several times)."""
        return f"mig:{self.gpu}:{self.slot}:{self.uuid}"


@dataclass(frozen=True)
class ProbeTargets:
    """The probe plan of a node with at least one GPU in MIG mode.
    ``gpu_uuids`` is the inventory in NVML order; ``plain`` the NVML
    indices of the GPUs outside MIG mode; ``mig`` every MIG device in
    NVML order. ``per_mig_device``: the labels index MIG devices (valid
    ``single``); ``per_device``: per-device labels are published at all
    (not under an invalid ``single``, whose ``problem`` says why)."""

    gpu_uuids: Tuple[str, ...]
    plain: Tuple[int, ...]
    mig: Tuple[MigTarget, ...]
    per_mig_device: bool
    per_device: bool
    problem: Optional[str] = None

    @property
    def plain_uuids(self) -> List[str]:
        return [self.gpu_uuids[i] for i in self.plain]

    def route_faults(self, sick, slow) -> Tuple[Shots, Dict[str, Shots]]:
        """Which probe enacts each ``chip.<i>.sick`` / ``chip.<i>.slow``
        shot (``i`` a label index): the classic probe's shots by NVML
        index (its inventory join maps them to devices), and per MIG
        worker key the label indices it enacts, on its one device. Under
        ``none``/``mixed`` a MIG GPU's index hits that GPU's first MIG
        device. An index that names nothing probed is dropped, as the
        classic probe drops one (with its warning there)."""
        classic: Tuple[set, set] = (set(), set())
        mig: Dict[str, Tuple[set, set]] = {}
        first_of: Dict[int, MigTarget] = {}
        for t in self.mig:
            first_of.setdefault(t.gpu, t)
        for kind, shots in enumerate((sick, slow)):
            for i in map(int, shots):
                if self.per_mig_device:
                    target = self.mig[i] if 0 <= i < len(self.mig) else None
                elif i in self.plain:
                    classic[kind].add(i)
                    continue
                else:
                    target = first_of.get(i)
                if target is not None:
                    mig.setdefault(target.key, (set(), set()))[kind].add(i)
        return (
            (frozenset(classic[0]), frozenset(classic[1])),
            {k: (frozenset(v[0]), frozenset(v[1])) for k, v in mig.items()},
        )


def probe_targets(manager: Manager,
                  strategy: str = TOPOLOGY_STRATEGY_NONE) -> Optional[ProbeTargets]:
    """The probe plan of ``manager``'s inventory under ``strategy``; None
    when no GPU is in MIG mode (the classic probe then takes every device
    CUDA lists, as before). Which GPUs are plain does not depend on the
    strategy."""
    chips = manager.get_chips()
    if not any(chip.is_slice_enabled() for chip in chips):
        return None
    problem = None
    if strategy == TOPOLOGY_STRATEGY_SINGLE:
        problem = SliceInfo(manager).single_strategy_problem()
    per_mig_device = strategy == TOPOLOGY_STRATEGY_SINGLE and problem is None
    mig: List[MigTarget] = []
    for gpu, chip in enumerate(chips):
        if not chip.is_slice_enabled():
            continue
        for slot, part in enumerate(chip.get_slices()):
            mig.append(MigTarget(
                uuid=part.get_uuid(),
                gpu=gpu,
                slot=slot,
                index=len(mig) if per_mig_device else gpu,
            ))
    return ProbeTargets(
        gpu_uuids=tuple(chip.get_uuid() for chip in chips),
        plain=tuple(i for i, chip in enumerate(chips) if not chip.is_slice_enabled()),
        mig=tuple(mig),
        per_mig_device=per_mig_device,
        per_device=problem is None,
        problem=problem,
    )
