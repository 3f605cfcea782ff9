"""chip_smoke's single-device serve phases from two checkouts, in one call,
so that two versions of the serving path are compared on one card.

    python tools/serve_ab.py --roots PARENT,CHANGE [--phases serve,serve_ssm]
        [--order abba]

Each run is a fresh process that imports ``chip_smoke`` from its root
(and that root's ``src``), builds the kernels there (``build_all``: a
root whose ``build/repro_torch`` already holds the libraries of the same
sources builds nothing) and runs ``serve_phase`` for each of
``--phases`` (names from ``chip_smoke.FAMILY_SERVES``, or ``serve``).
``--order`` is the sequence of roots by letter (``a`` the first of
``--roots``), so ``abba`` runs parent, change, change, parent.  Printed:
one JSON line a phase and run (root, prefill ms, replayed decode ms a
step and its kernel ms, eager decode ms a step, tokens/s, peak GB), and
last one JSON object with every row.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

RUN = r"""
import json, sys
root, phases = sys.argv[1], sys.argv[2].split(",")
sys.path.insert(0, root)
sys.path.insert(0, root + "/src")
import torch
import chip_smoke as cs
from repro_torch.kernels import _build
torch.backends.cuda.matmul.allow_tf32 = False
_build.build_all()
table = {"serve": (cs.SERVE_ARCH, {}, cs.SERVE_PROMPT)}
table.update({n: (a, c, p) for n, a, c, p in cs.FAMILY_SERVES})
for name in phases:
    arch, cut, prompt = table[name]
    row = cs.serve_phase(torch.device("cuda"), name, arch, cut=cut,
                         prompt_len=prompt)
    keys = ("prefill_ms", "decode_ms_per_step", "decode_kernel_ms_per_step",
            "eager_decode_ms_per_step", "tokens_per_s", "peak_mem_gb")
    print("AB " + json.dumps(dict(phase=name, **{k: row[k] for k in keys})),
          flush=True)
    torch.cuda.empty_cache()
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", required=True)
    ap.add_argument("--phases", default="serve,serve_ssm")
    ap.add_argument("--order", default="abba")
    args = ap.parse_args()
    roots = [os.path.abspath(r) for r in args.roots.split(",")]
    rows = []
    for letter in args.order:
        root = roots[ord(letter) - ord("a")]
        out = subprocess.run([sys.executable, "-c", RUN, root, args.phases],
                             capture_output=True, text=True, cwd=root)
        if out.returncode:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        for line in out.stdout.splitlines():
            if line.startswith("AB "):
                row = dict(root=letter, **json.loads(line[3:]))
                rows.append(row)
                print(json.dumps(row), flush=True)
    print(json.dumps(dict(roots=roots, order=args.order, rows=rows)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
