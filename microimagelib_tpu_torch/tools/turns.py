"""Run a ``*_times`` tool once per checkout of the package, in turns, each
in a process of its own, so that two versions of the package (e.g. a
parent commit unpacked by ``git archive`` beside the working tree) are
timed on one card: ``--roots build/parent,.,.,build/parent``.

A tool's main process calls :func:`in_turns`. Each child runs the tool's own
file with ``--one ROOT`` and ``ROOT`` first on ``PYTHONPATH``, so that it
imports that checkout's package; the child needs nothing of this module,
which a parent commit may lack.
"""

import os
import subprocess
import sys


def card_line():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def in_turns(script, roots, args):
    """Print the card line, then run ``script --one ROOT *args`` for each of
    the comma-separated ``roots`` in turn, passing each child's standard
    output through. Returns (the first non-zero exit code or 0, the
    children's standard outputs)."""
    print(card_line(), flush=True)
    outs = []
    for root in roots.split(","):
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, os.path.abspath(script), "--one", root,
                               *args], env=dict(os.environ, PYTHONPATH=root), cwd=root,
                              stdout=subprocess.PIPE, text=True)
        sys.stdout.write(proc.stdout)
        sys.stdout.flush()
        outs.append(proc.stdout)
        if proc.returncode:
            return proc.returncode, outs
    return 0, outs

