"""Stand-ins for the processes that probe a MIG node's MIG devices, for
the CPU tests of the PyTorch port.

On a MIG node the port probes each MIG device in a one-shot child pinned
to it (``lm.health._probe_mig_in_child``), on both the in-process and
the broker path. ``MigWorkers`` replaces that child with a probe in this
process, on one CPU device at the geometry the test sets
(``TFD_BURNIN_GEOMETRY``), and records what each device was asked. The
real pinned children are held by ``tests/test_torch_mig_probe.py``.
"""

import json

import torch

from gpu_feature_discovery_tpu_torch.lm import health
from gpu_feature_discovery_tpu_torch.ops.healthcheck import measure_node_health
from gpu_feature_discovery_tpu_torch.sandbox import broker as broker_mod

CPU = torch.device("cpu")


def pinned_report(request, sick=False):
    """What a pinned worker reports for ``request`` (a ``health``
    request's options): the probe of its one device, as JSON carries it.
    ``sick`` poisons the device's verdict input, as ``chip.0.sick``
    does."""
    opts = broker_mod.health_options(request)
    if sick:
        opts["sick_chips"] = frozenset({0})
    return json.loads(json.dumps(measure_node_health(devices=[CPU], **opts)))


class MigWorkers:
    """Fakes for every MIG device's probe process. ``sick`` names devices
    by ``(gpu, slot)`` that are always sick; ``fail`` maps ``(gpu, slot)``
    to the exception its probe raises (a hang killed at its deadline, a
    crash); ``busy`` names devices whose probe could not get device
    memory. ``requests`` records ``((gpu, slot), request)`` per probe."""

    def __init__(self, monkeypatch, sick=(), fail=None, busy=()):
        self.sick = set(sick)
        self.fail = dict(fail or {})
        self.busy = set(busy)
        self.requests = []
        # raising=False: on a tree without this seam the tests run against
        # its own MIG path (and show its fault).
        monkeypatch.setattr(health, "_probe_mig_in_child", self._child, raising=False)

    def probe(self, target, request):
        where = (target.gpu, target.slot)
        self.requests.append((where, request))
        if where in self.fail:
            raise self.fail[where]
        if where in self.busy:
            return {"status": "unacquirable", "error": "CUDA error: out of memory"}
        return {"status": "ok", "report": pinned_report(request, where in self.sick),
                "probe_ms": 1.0}

    def asked(self, where):
        """The requests the device at ``where`` received."""
        return [r for w, r in self.requests if w == where]

    def _child(self, target, config, request, pid_box=None):
        try:
            return self.probe(target, request)
        except Exception as e:  # noqa: BLE001 - the child's failed outcome
            return {"status": "probe-failed", "error": str(e)}
