"""Run ``chip_smoke.py``'s phase D (nucleus instances) in two trees, in turns, on one card.

    python3 scripts/ab_instance_phase.py PARENT_DIR CHANGE_DIR

Each directory holds a checkout of the repo (for example the parent commit
unpacked with ``git archive <commit> | tar -x -C PARENT_DIR``, and ``.``).
The turns go parent, change, change, parent; each is a subprocess started in
its tree that runs the smoke's ``phase_env``, ``phase_build`` and
``phase_instance``. For each turn it prints one JSON line with the turn's
wall seconds, one with the phase's seconds and the card (``nvidia-smi``'s
name and power limit), and phase D's three run lines cut to their path,
seconds, instance count, stages and, where the tree reports them, the drain
and the views check. A failing turn prints the end of its standard error.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

CODE = r"""
import json, tempfile, time
from pathlib import Path
import torch
import chip_smoke as cs
card = cs.phase_env()
cs.phase_build()
torch.cuda.empty_cache()
with tempfile.TemporaryDirectory(prefix="ab_") as tmp:
    t0 = time.perf_counter()
    cs.phase_instance(Path(tmp), card)
    seconds = time.perf_counter() - t0
print(json.dumps({"phase": "ab_instance", "instance_phase_seconds": seconds, "card": card}), flush=True)
"""

RUN_KEYS = ("path", "seconds", "instances", "stages", "drain", "views", "card")


def main(parent: str, change: str) -> int:
    failed = 0
    for turn, tree in enumerate((parent, change, change, parent)):
        t0 = time.time()
        out = subprocess.run([sys.executable, "-c", CODE], cwd=tree, capture_output=True, text=True)
        print(json.dumps({"turn": turn, "tree": tree, "rc": out.returncode, "wall": time.time() - t0}), flush=True)
        for line in out.stdout.splitlines():
            if not line.startswith("{"):
                continue
            obj = json.loads(line)
            if obj.get("phase") == "instance":
                print(json.dumps({k: obj.get(k) for k in RUN_KEYS}), flush=True)
            elif obj.get("phase") == "ab_instance":
                print(json.dumps(obj), flush=True)
        if out.returncode:
            failed = 1
            print(out.stderr[-4000:], flush=True)
    return failed


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
