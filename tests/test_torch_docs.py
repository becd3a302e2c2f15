"""The documentation contract of the PyTorch port: the twin's
``tests/test_docs.py``, test for test, holding ``docs/torch/`` and
``examples/torch/`` to the port's registries: its flags
(``config/flags.py`` ``FLAG_DEFS``, ``cmd/fleet.py`` ``FLEET_FLAG_DEFS``),
its config-file keys (through its own ``new_config``), its backend tokens
(``resource/registry.py``), the label keys its goldens
(``tests/torch-expected-output-*.txt``) and label constants pin, and its
``tfd_*`` registry (``obs/metrics.py``). A documentation row deleted, or a
flag, label family or metric added without one, fails here.

Label rows are matched as ``chip_smoke.py`` matches them on the card
(``doc_label_patterns``: the row's first cell, ``<i>`` a device index,
``<n>`` a cohort index, ``<profile>`` a MIG profile), so the CPU and the
card read the labels document alike.
"""

import glob
import os
import re

import pytest
import yaml

import chip_smoke
from gpu_feature_discovery_tpu_torch.actuation.engine import ADVICE_LABELS
from gpu_feature_discovery_tpu_torch.cmd.fleet import FLEET_FLAG_DEFS
from gpu_feature_discovery_tpu_torch.cmd.main import start
from gpu_feature_discovery_tpu_torch.cmd.supervisor import (
    DEGRADED_LABEL,
    RESTORED_LABEL,
    UNHEALTHY_CYCLES_LABEL,
)
from gpu_feature_discovery_tpu_torch.config import yaml_subset
from gpu_feature_discovery_tpu_torch.config.flags import CONFIG_FILE_ENV_VARS, FLAG_DEFS, new_config
from gpu_feature_discovery_tpu_torch.config.spec import file_key
from gpu_feature_discovery_tpu_torch.lm import health, slice_labeler
from gpu_feature_discovery_tpu_torch.lm.engine import STALE_SOURCES_LABEL
from gpu_feature_discovery_tpu_torch.lm.pjrt_family import FAMILY_DEGRADED_LABELS
from gpu_feature_discovery_tpu_torch.lm.timestamp import TIMESTAMP_LABEL
from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
from gpu_feature_discovery_tpu_torch.resource import registry
from gpu_feature_discovery_tpu_torch.sandbox.flap import FLAPPING_LABEL
from torch_env_guard import (  # noqa: F401 - autouse
    RESOLVED_CACHE_DIR_ENV,
    resolved_cache_dir_restored,
)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DOCS = os.path.join(REPO, "docs", "torch")
# Flags the CLI takes outside FLAG_DEFS (cmd/main.py, ops/kernel_cache.py).
OTHER_FLAGS = {"config-file", "version", "debug", "prebuild"}


def read(name):
    with open(os.path.join(DOCS, name)) as f:
        return f.read()


def _row(doc, first_cell):
    """The doc's table row whose first cell is ``first_cell``, or ""."""
    return next((line for line in doc.splitlines()
                 if line.startswith(f"| {first_cell}")), "")


def test_configuration_doc_covers_every_flag():
    doc = read("configuration.md")
    for fd in FLAG_DEFS:
        row = _row(doc, f"`--{fd.name}`")
        assert row, f"flag --{fd.name} has no row"
        for env in fd.env_vars:
            assert f"`{env}`" in row, f"env alias {env} undocumented"
        section, key = file_key(fd.name)
        path = ("flags." if section == "flags" else "flags.tfd.") + key
        assert f"`{path}`" in row, f"--{fd.name}: config-file key {path} undocumented"
        if isinstance(fd.default, bool):
            assert f"`{str(fd.default).lower()}`" in row, f"--{fd.name} default"
        elif isinstance(fd.default, (int, float)):
            rendered = (str(int(fd.default)) if float(fd.default).is_integer()
                        else str(fd.default))
            assert rendered in row, f"--{fd.name} default not documented"
        elif isinstance(fd.default, str) and fd.default:
            assert fd.default in row, f"--{fd.name} default not documented"
    for env in CONFIG_FILE_ENV_VARS:
        assert f"`{env}`" in doc


def test_configuration_doc_names_no_phantom_flags():
    """Every `--flag` the doc names exists (a removed or renamed flag
    fails here)."""
    doc = read("configuration.md")
    known = ({fd.name for fd in FLAG_DEFS}
             | {a for fd in FLAG_DEFS for a in fd.aliases}
             | {fd.name for fd in FLEET_FLAG_DEFS} | OTHER_FLAGS)
    named = re.findall(r"`--([a-z][a-z0-9-]*)", doc)
    assert named
    for name in named:
        assert name in known, f"doc names unknown flag --{name}"
    for name in OTHER_FLAGS:
        assert _row(doc, f"`--{name}`"), f"--{name} has no row"


def test_configuration_doc_covers_every_fleet_flag():
    doc = read("configuration.md")
    fleet = doc[doc.index("## Fleet collector flags"):]
    for fd in FLEET_FLAG_DEFS:
        row = _row(fleet, f"`--{fd.name}`")
        assert row, f"fleet flag --{fd.name} undocumented"
        for env in fd.env_vars:
            assert f"`{env}`" in row, f"env alias {env} undocumented"


def test_configuration_doc_config_file_keys_parse(tmp_path):
    """The doc's YAML example names every flag's key and goes through the
    port's own parser and ``new_config``, as pyyaml reads it."""
    doc = read("configuration.md")
    (block,) = re.findall(r"```yaml\n(.*?)```", doc, flags=re.S)
    assert yaml_subset.safe_load(block) == yaml.safe_load(block)
    raw = yaml.safe_load(block)
    assert raw["version"] == "v1"
    for fd in FLAG_DEFS:
        section, key = file_key(fd.name)
        table = raw["flags"] if section == "flags" else raw["flags"]["tfd"]
        assert key in table, f"config-file key {key} of --{fd.name} not in the example"
    path = tmp_path / "example.yaml"
    path.write_text(block)
    config = new_config(cli_values={}, environ={}, config_file=str(path))
    assert config.flags.tpu_topology_strategy == "single"
    assert config.flags.tfd.fail_on_init_error is False
    assert config.flags.tfd.sleep_interval == 60.0
    assert config.flags.tfd.burnin_interval == 10
    assert config.flags.tfd.actuation == "off"
    assert config.sharing.time_slicing.resources[0].replicas == 4


def _golden_label_keys():
    """Every label key the port's goldens pin (a regex golden escapes its
    dots and slashes)."""
    keys = set()
    for path in glob.glob(os.path.join(HERE, "torch-expected-output-*.txt")):
        with open(path) as f:
            for line in f:
                key = line.split("=", 1)[0].strip()
                if key:
                    keys.add(key.replace("\\.", ".").replace("\\/", "/"))
    return keys


def _constant_label_keys():
    """The label keys no golden can pin: measured health, the slice and
    advice families, and the markers of a degraded, restored, flapping or
    stale cycle."""
    keys = {v for k, v in vars(health).items()
            if k.startswith(("HEALTH_", "CHIPS_")) and isinstance(v, str)}
    keys |= {health.CHIP_OK_FMT % 0, health.CHIP_TFLOPS_FMT % 0,
             health.CHIP_HBM_FMT % 0, health.STRAGGLER_CHIP}
    keys |= {v for k, v in vars(slice_labeler).items()
             if k.startswith("SLICE_") and k.endswith("_LABEL")}
    keys.add(slice_labeler.cohort_degraded_label(3))
    keys |= set(ADVICE_LABELS) | set(FAMILY_DEGRADED_LABELS.values())
    keys |= {TIMESTAMP_LABEL, DEGRADED_LABEL, RESTORED_LABEL, UNHEALTHY_CYCLES_LABEL,
             FLAPPING_LABEL, STALE_SOURCES_LABEL}
    return keys


@pytest.fixture(scope="module")
def emitted_keys(tmp_path_factory):
    """The goldens' keys, the constants, and a oneshot's with both label
    families (the cpu family has no golden). The oneshot exports its
    resolved kernel cache directory, which is put back at once: a
    module-scoped fixture runs outside the per-test guard."""
    out = tmp_path_factory.mktemp("oneshot") / "tfd"
    saved = os.environ.get(RESOLVED_CACHE_DIR_ENV)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TFD_HERMETIC", "1")
        try:
            assert start(["--oneshot", "--backends", "mock-gpu:2,mock-cpu:1",
                          "--output-file", str(out)]) == 0
        finally:
            if saved is None:
                os.environ.pop(RESOLVED_CACHE_DIR_ENV, None)
            else:
                os.environ[RESOLVED_CACHE_DIR_ENV] = saved
    oneshot = {line.split("=", 1)[0] for line in out.read_text().splitlines()}
    return _golden_label_keys() | _constant_label_keys() | oneshot


def test_examples_reference_only_real_labels(emitted_keys):
    """examples/torch/ selectors key only on labels the port emits."""
    examples = glob.glob(os.path.join(REPO, "examples", "torch", "*.yaml"))
    assert examples
    checked = 0
    for path in examples:
        with open(path) as f:
            text = f.read()
        for m in re.finditer(r"(nvidia\.com/(?:gpu|mig-)[a-z0-9._-]*|google\.com/tfd[a-z0-9._-]*)",
                             text):
            key = m.group(1)
            if key == "nvidia.com/gpu":  # the extended resource, not a label
                continue
            assert key in emitted_keys, f"{path} references unknown label {key}"
            checked += 1
    assert checked >= 3  # the guard must keep matching something


def test_labels_doc_covers_emitted_label_families(emitted_keys):
    """Every key the goldens, the constants and a oneshot give has its row
    in docs/torch/labels.md."""
    doc = read("labels.md")
    missing = chip_smoke.undocumented_labels(emitted_keys, doc)
    assert not missing, f"label keys undocumented in labels.md: {missing}"
    # The label rule's MIG table (ROADMAP.md), twin key to port key.
    for twin, port in (("`google.com/tpu-<topology>.*`", "`nvidia.com/mig-<profile>.*`"),
                       ("`<model>-SLICE-INVALID`", "`<model>-MIG-INVALID`"),
                       ("`tensorcores`, `sparsecores`", "not published"),
                       ("`slice.chips`", "`slices.gi`"),
                       ("`family` from the TPU generation table",
                        "`family` from the compute capability")):
        assert any(twin in line and port in line for line in doc.splitlines()), (
            f"the MIG table has no row {twin} -> {port}")


def test_configuration_doc_covers_every_backend_token():
    """The --backends table tracks the registry's tokens both ways."""
    doc = read("configuration.md")
    for name in registry.backend_spec_tokens():
        base = name.rstrip(":")
        assert re.search(rf"`{re.escape(base)}[`:\[]", doc), (
            f"backend token {name!r} undocumented in configuration.md")
    prefixes = re.findall(r"`(mock[a-z-]*)(?::<|\[:<)", doc)
    assert prefixes
    for match in prefixes:
        assert (registry.provider_for(f"{match}:2") is not None
                or registry.provider_for(f"{match}:none") is not None), (
            f"doc names backend prefix {match!r} the registry rejects")


def _backend_rows(doc):
    """(token, family) of each row of the --backends table, in order."""
    return re.findall(r"^\| `([a-z-]+:?)(?:<[a-z]+>|\[:<n>\])?` \| (gpu|cpu) \|", doc, re.M)


def test_configuration_doc_has_a_row_per_provider_in_registration_order():
    """Every provider ``registry.providers()`` returns has its row, in the
    registration order the table documents, with its family."""
    rows = _backend_rows(read("configuration.md"))
    assert rows == [(p.name, p.family) for p in registry.providers()]
    doc = read("configuration.md")
    for name in ("register(provider)", "providers()", "resolved_backends_value(config)"):
        assert name in doc, f"configuration.md does not document {name}"


def _families():
    return obs_metrics.REGISTRY.families()


def _typed_rows(expected):
    families = _families()
    doc = read("observability.md")
    for name, kind in expected.items():
        assert name in families, f"{name} missing from the registry"
        assert families[name].kind == kind, name
        assert kind in _row(doc, f"`{name}`"), f"{name}: no doc row stating {kind!r}"
    return families, doc


def test_cohort_metric_families_are_registered_and_documented():
    _typed_rows({"tfd_cohort_leaders": "gauge", "tfd_cohort_degraded": "gauge",
                 "tfd_cohort_poll_rounds_total": "counter"})
    ops = read("operations.md")
    assert "Two-tier coordination" in ops
    for label_bit in ("slice.cohort.<i>.degraded", "cohort-leader"):
        assert label_bit in ops


def test_fleet_metric_families_are_registered_and_documented():
    families, _ = _typed_rows({
        "tfd_fleet_slices": "gauge",
        "tfd_fleet_slices_stale": "gauge",
        "tfd_fleet_polls_total": "counter",
        "tfd_fleet_snapshot_not_modified_total": "counter",
        "tfd_fleet_inventory_not_modified_total": "counter",
        "tfd_fleet_scrape_rounds_total": "counter",
        "tfd_fleet_scrape_round_duration_seconds": "histogram",
        "tfd_fleet_restored": "gauge",
        "tfd_fleet_regions": "gauge",
        "tfd_fleet_regions_stale": "gauge",
        "tfd_fleet_ha_role": "gauge",
        "tfd_fleet_ha_divergence": "gauge",
        "tfd_fleet_etag_missing_total": "counter",
        "tfd_fleet_delta_served_total": "counter",
        "tfd_fleet_delta_polls_total": "counter",
        "tfd_fleet_poll_body_bytes_total": "counter",
    })
    assert families["tfd_fleet_polls_total"].labelnames == ("outcome",)
    assert families["tfd_fleet_delta_served_total"].labelnames == ("outcome",)
    assert families["tfd_fleet_delta_polls_total"].labelnames == ("kind",)
    assert families["tfd_fleet_poll_body_bytes_total"].labelnames == ("kind",)
    ops = read("operations.md")
    assert "Running the fleet collector" in ops
    for bit in ("/fleet/snapshot", "--peer-token", "targets"):
        assert bit in ops, f"fleet runbook missing {bit!r}"
    assert "Federating the fleet plane" in ops
    for bit in ("--upstream-mode", "--ha-peers", "region/<name>/<slice>", "DARK REGION",
                "DEAD ROOT", "SPLIT HA PANE", "Token rollout across two hops"):
        assert bit in ops, f"federation runbook missing {bit!r}"
    assert "Delta sync and resync" in ops
    for bit in ("?since=", "generation", "tombstone", "--delta-window", "resync",
                "fleet:delta-resync"):
        assert bit in ops, f"delta runbook missing {bit!r}"


def test_actuation_families_are_registered_and_documented():
    families, doc = _typed_rows({
        "tfd_actuation_advice": "gauge",
        "tfd_actuation_budget_exhausted": "gauge",
        "tfd_actuation_transitions_total": "counter",
        "tfd_actuation_convergence_cycles": "gauge",
        "tfd_fleet_targets_reload_failures_total": "counter",
    })
    assert families["tfd_actuation_transitions_total"].labelnames == ("action",)
    row = _row(doc, "`tfd_actuation_transitions_total`")
    for action in ("fired", "cleared", "budget-suppressed", "lease-lapsed"):
        assert action in row, f"transition action {action!r} undocumented"
    labels_doc = read("labels.md")
    assert "Actuation advice labels" in labels_doc
    for label in ADVICE_LABELS:
        assert _row(labels_doc, f"`{label}`"), f"advice label {label} has no row"
    ops = read("operations.md")
    assert "Acting on verdicts safely" in ops
    for bit in ("--actuation=advise", "--actuation=enforce", "--actuation-window",
                "--max-actuated-fraction", "tfd_actuation_budget_exhausted", "lease",
                "actuation:sick-chip-cordon", "actuation:budget-storm", "--actuation=off"):
        assert bit in ops, f"actuation runbook missing {bit!r}"


def test_query_surface_families_are_registered_and_documented():
    families, doc = _typed_rows({
        "tfd_fleet_filter_views": "gauge",
        "tfd_fleet_filter_cache_total": "counter",
        "tfd_fleet_filter_renders_total": "counter",
        "tfd_fleet_filtered_not_modified_total": "counter",
        "tfd_fleet_query_rejected_total": "counter",
        "tfd_fleet_watchers": "gauge",
        "tfd_fleet_watch_total": "counter",
        "tfd_http_inflight": "gauge",
        "tfd_http_rejected_total": "counter",
    })
    assert families["tfd_fleet_filter_cache_total"].labelnames == ("outcome",)
    assert families["tfd_fleet_watch_total"].labelnames == ("outcome",)
    for name, outcomes in (("tfd_fleet_filter_cache_total", ("hit", "miss", "evict")),
                           ("tfd_fleet_watch_total", ("delta", "timeout", "rejected"))):
        row = _row(doc, f"`{name}`")
        for outcome in outcomes:
            assert outcome in row, f"{name} outcome {outcome!r} undocumented"
    endpoint_row = _row(doc, "`/fleet/snapshot`")
    for bit in ("?region=", "degraded=true", "sick-chips", "max-age", "watch=", "400",
                "Retry-After"):
        assert bit in endpoint_row, f"/fleet/snapshot endpoint row missing {bit!r}"
    ops = read("operations.md")
    assert "Serving dashboards and schedulers at scale" in ops
    for bit in ("?degraded=true", "max-age", "canonicalized", "--filter-cache-size",
                "&watch=", "--watch-timeout", "--max-watchers", "--max-inflight-requests",
                "Retry-After", "fleet:watch-failover", "tfd_fleet_filter_views",
                "tfd_fleet_watchers", "tfd_http_rejected_total"):
        assert bit in ops, f"query-surface runbook missing {bit!r}"


def test_observability_doc_rows_are_the_registry_both_ways():
    """Every registered family has a typed row, and no row names a family
    the registry lacks: chip_smoke.py holds the same rows to every family
    it scrapes on the card."""
    families = _families()
    doc = read("observability.md")
    documented = chip_smoke.doc_metric_families(doc)
    assert documented == set(families), (
        f"undocumented {sorted(set(families) - documented)}, "
        f"phantom {sorted(documented - set(families))}")
    for name, family in families.items():
        assert f"| {family.kind} |" in _row(doc, f"`{name}`"), name


def test_every_labels_doc_row_is_a_key_the_port_can_emit(emitted_keys):
    """No labels.md row outlives its key: each matches a key the goldens,
    the constants or a oneshot give."""
    doc = read("labels.md")
    for pattern in chip_smoke.doc_label_patterns(doc):
        assert any(pattern.fullmatch(k) for k in emitted_keys), (
            f"labels.md row {pattern.pattern} matches no key the port emits")
