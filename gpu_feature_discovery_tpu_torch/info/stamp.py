"""Write ``info/_build_info.py``, the link-time injection of the
reference's version (twin: ``gpu_feature_discovery_tpu/info/stamp.py``).

Reference: versions.mk derives GIT_COMMIT with ``git describe`` and the
Makefile links it into the binary (internal/info/version.go:22-43). Here
``make stamp-torch`` runs this module before a wheel or an image is cut,
so ``--version`` in a released artifact reports its real provenance.

Usage: python -m gpu_feature_discovery_tpu_torch.info.stamp \\
           [--version V] [--git-commit SHA] [--out PATH]
Defaults: version = info.version.DEFAULT_VERSION, commit = ``git
describe --match="" --dirty --long --always --abbrev=40`` (empty outside
a git checkout), out = ``_build_info.py`` next to this file.
"""

from __future__ import annotations

import argparse
import os
import subprocess

from gpu_feature_discovery_tpu_torch.info.version import DEFAULT_VERSION

TEMPLATE = '''\
"""Generated by info/stamp.py at build time. Do not edit or commit."""

VERSION = {version!r}
GIT_COMMIT = {commit!r}
'''

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build_info.py")


def describe_git_commit(cwd: str | None = None) -> str:
    """The reference's describe recipe (versions.mk): the full 40-character
    sha, a -dirty suffix on a modified tree, empty outside a checkout."""
    try:
        out = subprocess.run(
            ["git", "describe", "--match=", "--dirty", "--long", "--always",
             "--abbrev=40"],
            capture_output=True, text=True, cwd=cwd, timeout=10,
        )
    except OSError:
        return ""
    return out.stdout.strip() if out.returncode == 0 else ""


def render(version: str, commit: str) -> str:
    return TEMPLATE.format(version=version, commit=commit)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--version", default=DEFAULT_VERSION)
    parser.add_argument("--git-commit", default=None,
                        help="defaults to git describe of the current checkout")
    parser.add_argument("--out", default=DEFAULT_OUT)
    args = parser.parse_args(argv)
    commit = args.git_commit if args.git_commit is not None else describe_git_commit()
    with open(args.out, "w") as f:
        f.write(render(args.version, commit))
    print(f"stamped {args.out}: version={args.version} commit={commit or '(none)'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
