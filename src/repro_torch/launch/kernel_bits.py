"""Save every RPCA kernel's outputs for the tree on ``PYTHONPATH``, or
compare two saved files bit for bit.

    PYTHONPATH=<tree>/src python src/repro_torch/launch/kernel_bits.py save OUT.pt
    python src/repro_torch/launch/kernel_bits.py compare A.pt B.pt

``save`` runs the public wrappers (``huber_contract_v``, ``_u``,
``_u_diag``, ``huber_dual_contract``, ``residual_shrink``, ``_psi``) in
every mask mode (none, dense, bit-packed) and data type (fp32, bf16 M) at
ranks 1 to 512 (one register block; two rank slices, or the shrink's
stream kernel) on three shapes, from inputs made from a seed, and saves
the outputs on the host.  ``compare`` prints one JSON line: the cases
compared, those whose bits differ (the first 50) and their count by
function and rank.  Run ``save`` for two checkouts (for example the parent's, unpacked
with ``git archive``) on one card, then ``compare``.  ``save`` needs a CUDA
card and exits 2 without one.
"""
from __future__ import annotations

import json
import sys

import torch

SHAPES = [(2, 200, 133), (1, 700, 650), (10, 500, 120)]
RANKS = [1, 64, 150, 256, 300, 448, 500, 512]
FUNCTIONS = ["huber_contract_v", "huber_contract_u", "huber_contract_u_diag",
             "huber_dual_contract", "residual_shrink", "residual_shrink_psi"]


def save(path: str) -> int:
    if not torch.cuda.is_available():
        print("kernel_bits: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import bitmask
    from repro_torch.kernels import huber_contract as hc
    from repro_torch.kernels import shrinkage as sh

    dev = torch.device("cuda")
    out = {}
    for shape in SHAPES:
        e, m, n = shape
        for r in RANKS:
            for dtype in (torch.float32, torch.bfloat16):
                g = torch.Generator().manual_seed(r)
                u = torch.randn(e, m, r, generator=g) / r ** 0.5
                v = torch.randn(e, n, r, generator=g) / r ** 0.5
                mat = torch.randn(e, m, n, generator=g) * 2
                mat[torch.rand(e, m, n, generator=g) < 0.05] = 3000.0
                w = (torch.rand(e, m, n, generator=g) < 0.7).float()
                lam = torch.linspace(0.5, 2.0, e)
                u, v, mat, w, lam = (x.to(dev) for x in
                                     (u, v, mat.to(dtype), w, lam))
                for mode, wm in (("none", None), ("dense", w),
                                 ("packed", bitmask.pack_mask(w))):
                    for fn in FUNCTIONS:
                        module = sh if fn.startswith("residual") else hc
                        res = getattr(module, fn)(u, v, mat, lam, wm)
                        res = res if isinstance(res, tuple) else (res,)
                        key = f"{fn}/{mode}/{str(dtype)[6:]}/r{r}/{shape}"
                        out[key] = [x.cpu() for x in res]
    torch.save(out, path)
    print(json.dumps(dict(saved=len(out), path=path)))
    return 0


def compare(a_path: str, b_path: str) -> int:
    a, b = torch.load(a_path), torch.load(b_path)
    differ = [k for k in a if k not in b or not all(
        torch.equal(x, y) for x, y in zip(a[k], b[k]))]
    by_rank = {}
    for k in differ:
        fn, _, _, r, _ = k.split("/", 4)
        by_rank[f"{fn}/{r}"] = by_rank.get(f"{fn}/{r}", 0) + 1
    print(json.dumps(dict(compared=len(a), differ=len(differ),
                          cases=differ[:50], by_function_rank=by_rank)))
    return 0 if not differ else 1


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "save":
        sys.exit(save(sys.argv[2]))
    if len(sys.argv) == 4 and sys.argv[1] == "compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    print(__doc__, file=sys.stderr)
    sys.exit(2)
