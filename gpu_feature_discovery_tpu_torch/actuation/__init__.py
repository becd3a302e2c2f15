"""Fail-safe verdict actuation (twin:
``gpu_feature_discovery_tpu/actuation/``): confirmed health verdicts
projected into scheduler-consumable advice labels through the label file
the daemon already writes, with confirmation gating, a slice-wide budget,
leased fail-static advice and a dry-run mode. See engine.py."""

from gpu_feature_discovery_tpu_torch.actuation.engine import (  # noqa: F401
    ACTUATION_LEASE_LABEL,
    ADVICE_LABELS,
    CORDON_ADVICE_LABEL,
    DRAIN_ADVICE_LABEL,
    LEASE_TTL_FACTOR,
    REASON_SICK_CHIPS,
    REASON_STRAGGLER,
    SCHEDULABLE_LABEL,
    WOULD_CORDON_LABEL,
    ActuationEngine,
    advice_present,
    budget_allowance,
    drop_lapsed_advice,
    lease_expiry,
    new_actuation_engine,
)
