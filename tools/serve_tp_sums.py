"""How the row-parallel sums move serve_tp's logits, on one card.

    python3 tools/serve_tp_sums.py

Run from the root of a checkout on a machine with a CUDA card: builds the
kernels, runs ``chip_smoke.py``'s ``serve`` phase (Llama-3-8B, which
writes the yardstick ``serve_tp`` reads), then its ``serve_tp`` phase
twice in one process, alternating nothing else: as the port runs it
(``TensorParallel.row_parallel``: the partial products of ``wo`` and
``w_down`` in fp32, added by an fp32 all-reduce, rounded once) and with
the partial products rounded to bf16 before a bf16 all-reduce.  Each
prints its ``serve_tp`` line (logits against serve's, walls, collective
bytes); a variant past the phase's bound prints ``FAILED`` and goes on.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# Prepended to the worker: the row-parallel product with bf16 partial sums.
BF16_SUMS = '''
from repro_torch.models import parallel as _par
def _bf16_sums(self, x, w):
    return self.all_reduce(x @ w)
_par.TensorParallel.row_parallel = _bf16_sums
'''


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("serve_tp_sums: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    cs.emit(phase="device", nvidia_smi=cs.nvidia_smi_line())
    cs.emit(phase="build", seconds=_build.build_all())
    serve = cs.serve_phase(device)
    torch.cuda.empty_cache()
    port = cs.SERVE_TP_WORKER
    marker = "torch.backends.cuda.matmul.allow_tf32 = False\n"
    for name, worker in (("fp32_sums", port),
                         ("bf16_sums", port.replace(marker,
                                                    marker + BF16_SUMS, 1))):
        cs.SERVE_TP_WORKER = worker
        print(f"VARIANT {name}", flush=True)
        try:
            cs.serve_tp_phase(device, serve)
        except SystemExit as e:
            print(f"FAILED {name}: {e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
