"""Run a tool of this checkout on another checkout's code.

``run_in_tree(script, tree, argv)`` starts ``script`` (a file of this
checkout) in a child process whose working directory and import path are
``tree``, for example an unpacked ``git archive`` of a parent commit: the
child's ``import chip_smoke`` and ``import seervideoldm_tpu_torch`` resolve
there, so that checkout's kernels are built and timed by the same
measuring code, in one call on one card.
"""
from __future__ import annotations

import os
import subprocess
import sys


def run_in_tree(script: str, tree: str, argv: list) -> int:
    root = os.path.abspath(tree)
    cmd = [sys.executable, os.path.abspath(script), *argv]
    return subprocess.run(cmd, cwd=root, check=False,
                          env=dict(os.environ, PYTHONPATH=root)).returncode
