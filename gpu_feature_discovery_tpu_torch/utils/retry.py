"""Bounded exponential backoff with jitter (twin:
``gpu_feature_discovery_tpu/utils/retry.py``).

The daemon supervisor (cmd/supervisor.py) spaces backend-init
re-attempts and failed-cycle retries with this policy: exponential
growth bounds the retry pressure on a broken dependency, the cap keeps
recovery latency bounded once it heals, and jitter keeps a rack of pods
that failed at the same instant from retrying in lockstep. Jitter comes
from an injectable ``random.Random`` so tests pin exact delays with
``jitter=0`` or a seeded generator.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

DEFAULT_BASE_S = 1.0
DEFAULT_FACTOR = 2.0
DEFAULT_CAP_S = 30.0
DEFAULT_JITTER = 0.1


@dataclass
class BackoffPolicy:
    """Delay schedule: ``min(cap, base * factor**attempt)`` spread by
    ``±jitter`` (a fraction of the delay). ``attempt`` is 0-based — the
    delay *after* the first failure is ``delay(0)``."""

    base: float = DEFAULT_BASE_S
    factor: float = DEFAULT_FACTOR
    cap: float = DEFAULT_CAP_S
    jitter: float = DEFAULT_JITTER
    rng: random.Random = field(default_factory=random.Random)

    def delay(self, attempt: int) -> float:
        """Delay in seconds before retry number ``attempt + 1``."""
        if attempt < 0:
            raise ValueError(f"attempt must be >= 0, got {attempt}")
        # The exponent is capped too: factor**attempt overflows to inf
        # after ~1000 doublings.
        raw = self.base * (self.factor ** min(attempt, 64))
        bounded = min(self.cap, raw)
        if not self.jitter:
            return bounded
        spread = self.jitter * bounded
        return max(0.0, bounded + self.rng.uniform(-spread, spread))
