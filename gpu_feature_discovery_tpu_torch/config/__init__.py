"""config (twin: ``gpu_feature_discovery_tpu/config/``).

The twin's re-exports, resolved on first use (PEP 562): a probe child
imports ``config.spec`` and must not pay for the flag table.
"""

import importlib

_EXPORTS = {
    "spec": (
        "Config",
        "Flags",
        "TfdFlags",
        "Sharing",
        "TimeSlicing",
        "ReplicatedResource",
        "TOPOLOGY_STRATEGY_NONE",
        "TOPOLOGY_STRATEGY_SINGLE",
        "TOPOLOGY_STRATEGY_MIXED",
        "CONFIG_VERSION",
    ),
    "flags": ("FLAG_DEFS", "FlagDef", "new_config", "parse_duration"),
}
_HOME = {name: module for module, names in _EXPORTS.items() for name in names}
# The twin's name for spec.VERSION.
_RENAMED = {"CONFIG_VERSION": "VERSION"}

__all__ = list(_HOME)


def __getattr__(name):
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_HOME[name]}")
    value = globals()[name] = getattr(module, _RENAMED.get(name, name))
    return value


def __dir__():
    return sorted(set(globals()) | set(_HOME))
