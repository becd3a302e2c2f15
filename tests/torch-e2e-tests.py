#!/usr/bin/env python3
"""Tier-4 E2E test of the PyTorch port against a cluster: the port's
counterpart of tests/e2e-tests.py, with the same contract.

Deploy NFD and the port's manifest (a static DaemonSet of
deployments/torch/static/ or its Job with NODE_NAME filled in), watch the
Nodes until the timestamp label lands (180 s budget), then hold each
labeled Node's labels to the golden plus whatever labels it had before,
NFD's own ``feature.node.kubernetes.io/*`` ignored. The port's daemon
markers keep the twin's ``google.com/tfd.*`` keys, so the timestamp is
``google.com/tfd.timestamp`` here too.

--slice-consistency N waits for N labeled nodes instead of one and also
holds the coordination-free multi-host invariant: every worker of one
slice derives IDENTICAL slice-global labels (the ``nvidia.com/gpu.slice.*``,
``multihost.*`` and ``ici.*`` families the port publishes from its
``WORKER_*`` environment) with distinct ``multihost.worker-id`` labels.

It runs on the standard library plus pyyaml, through tests/k8s_stdlib.py
(no ``kubernetes`` package): against the fake API server of
tests/test_torch_e2e_script.py, against kind, or against a real cluster.
The GPU card machine has no API server and no pyyaml, so this tier runs
on the CPU only.

Usage: python tests/torch-e2e-tests.py TFD_YAML NFD_YAML [GOLDEN]
       python tests/torch-e2e-tests.py --skip-deploy [GOLDEN]
Env: KUBECONFIG selects the cluster; TFD_E2E_WATCH_TIMEOUT_S overrides
the 180 s watch budget.
"""

import importlib.util
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
TIMESTAMP_LABEL = "google.com/tfd.timestamp"
WATCH_TIMEOUT_S = float(os.environ.get("TFD_E2E_WATCH_TIMEOUT_S", "180"))

sys.path.insert(0, HERE)
from golden_utils import load_golden_regexs  # noqa: E402
from k8s_stdlib import KubeClient  # noqa: E402


def _twin_script():
    """tests/e2e-tests.py, whose manifest deploy and NFD-aware diff this
    script shares."""
    spec = importlib.util.spec_from_file_location(
        "twin_e2e_tests", os.path.join(HERE, "e2e-tests.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_TWIN = _twin_script()
deploy_yaml_file = _TWIN.deploy_yaml_file
check_labels = _TWIN.check_labels

# Our own namespaces: governed by the goldens, so a Node's stale values
# there are never allowed through as pre-existing labels.
OWN_PREFIXES = ("google.com/", "nvidia.com/")
# Label families every worker of one slice must agree on: they describe
# the slice, and each worker derives them from its own environment.
SLICE_GLOBAL_PREFIXES = (
    "nvidia.com/gpu.slice.",
    "nvidia.com/gpu.multihost.",
    "nvidia.com/gpu.ici.",
)
WORKER_ID_LABEL = "nvidia.com/gpu.multihost.worker-id"
WORKER_LOCAL_LABELS = frozenset({WORKER_ID_LABEL})


def slice_global_view(labels):
    return {
        k: v
        for k, v in labels.items()
        if k.startswith(SLICE_GLOBAL_PREFIXES) and k not in WORKER_LOCAL_LABELS
    }


def check_slice_consistency(node_labels):
    """``node_labels``: {node_name: {label: value}} for every labeled
    node. True when the worker ids are present and distinct and every
    node's slice-global view is the same and not empty."""
    ok = True
    ids = {n: ls.get(WORKER_ID_LABEL) for n, ls in node_labels.items()}
    if None in ids.values() or len(set(ids.values())) != len(ids):
        print(f"worker-id labels missing or not distinct: {ids}", file=sys.stderr)
        ok = False
    views = {n: slice_global_view(ls) for n, ls in node_labels.items()}
    base_node = next(iter(views))
    base = views[base_node]
    if not base:
        print("no slice-global labels present", file=sys.stderr)
        ok = False
    for n, view in views.items():
        if view != base:
            diff = sorted(set(base.items()) ^ set(view.items()))
            print(f"slice-global labels disagree ({base_node} vs {n}): {diff}",
                  file=sys.stderr)
            ok = False
    if ok:
        print(f"Slice consistency OK across {len(node_labels)} nodes "
              f"({len(base)} slice-global labels, worker ids "
              f"{sorted(ids.values())})")
    return ok


def parse_argv(argv):
    """(skip_deploy, expect_nodes, positional) or None on a usage error."""
    argv = list(argv)
    skip_deploy = "--skip-deploy" in argv
    if skip_deploy:
        argv.remove("--skip-deploy")
    expect_nodes = 1
    if "--slice-consistency" in argv:
        i = argv.index("--slice-consistency")
        try:
            expect_nodes = int(argv[i + 1])
        except (IndexError, ValueError):
            print("--slice-consistency needs a node count", file=sys.stderr)
            return None
        del argv[i:i + 2]
        if expect_nodes < 2:
            print("--slice-consistency needs >= 2 nodes", file=sys.stderr)
            return None
    if (skip_deploy and len(argv) > 1) or (not skip_deploy and len(argv) not in (2, 3)):
        print(f"Usage: {sys.argv[0]} TFD_YAML NFD_YAML [GOLDEN]\n"
              f"       {sys.argv[0]} --skip-deploy [GOLDEN]", file=sys.stderr)
        return None
    return skip_deploy, expect_nodes, argv


def watch_for_labeled_nodes(client, expect_nodes, skip_deploy):
    labeled = []  # distinct, in labeling order
    # Deployed elsewhere: the label may have landed before the watch
    # opens. A fresh deploy must not take this shortcut, or a stale
    # timestamp of an earlier deploy would pass unchecked.
    if skip_deploy:
        for n in client.get("/api/v1/nodes").get("items", []):
            if TIMESTAMP_LABEL in (n["metadata"].get("labels") or {}):
                labeled.append(n["metadata"]["name"])
                print(f"Timestamp label already on {labeled[-1]}. Not watching")
                if len(labeled) >= expect_nodes:
                    return labeled
    for event in client.watch("/api/v1/nodes", timeout_s=WATCH_TIMEOUT_S):
        if event.get("type") != "MODIFIED":
            continue
        labels = event["object"]["metadata"].get("labels") or {}
        name = event["object"]["metadata"]["name"]
        if TIMESTAMP_LABEL in labels and name not in labeled:
            labeled.append(name)
            print(f"Timestamp label found on {name}. ", end="")
            if len(labeled) >= expect_nodes:
                print("Stop watching")
                break
            print(f"Waiting for {expect_nodes - len(labeled)} more")
    return labeled


def main(argv=None):
    parsed = parse_argv(sys.argv[1:] if argv is None else argv)
    if parsed is None:
        return 1
    skip_deploy, expect_nodes, args = parsed
    golden = (args[-1] if (skip_deploy and args) or (not skip_deploy and len(args) == 3)
              else os.path.join(HERE, "torch-expected-output-h100x2.txt"))

    print("Running E2E tests for the PyTorch port")
    client = KubeClient.from_kubeconfig()
    nodes = client.get("/api/v1/nodes").get("items", [])
    if not nodes:
        print("No nodes found", file=sys.stderr)
        return 1
    pre_labels = {n["metadata"]["name"]: dict(n["metadata"].get("labels") or {})
                  for n in nodes}
    if skip_deploy:
        print("Skipping deploy (deployed externally)")
    else:
        print("Deploying NFD and the port")
        # NFD first: it creates the namespace the port deploys into.
        deploy_yaml_file(client, args[1])
        deploy_yaml_file(client, args[0])

    print("Watching node updates")
    labeled = watch_for_labeled_nodes(client, expect_nodes, skip_deploy)
    if len(labeled) < expect_nodes:
        print(f"Timestamp label appeared on {len(labeled)}/{expect_nodes} nodes",
              file=sys.stderr)
        return 1

    print("Checking labels")
    regexs = load_golden_regexs(golden)
    node_labels = {}
    for name in labeled:
        node = client.get(f"/api/v1/nodes/{name}")
        node_labels[name] = dict(node["metadata"].get("labels") or {})
        node_regexs = list(regexs) + [
            re.compile(re.escape(f"{k}={v}"))
            for k, v in pre_labels.get(name, {}).items()
            if not k.startswith(OWN_PREFIXES)
        ]
        if not check_labels(node_regexs, [f"{k}={v}" for k, v in node_labels[name].items()]):
            print(f"E2E tests failed on {name}", file=sys.stderr)
            return 1
    if expect_nodes > 1 and not check_slice_consistency(node_labels):
        print("E2E tests failed", file=sys.stderr)
        return 1
    print("E2E tests done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
