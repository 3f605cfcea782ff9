"""Distributed RPCA over ``torch.distributed`` ranks on the PyTorch/CUDA
port (the sharded engine; the counterpart of ``examples/distributed_rpca.py``).

    PYTHONPATH=src python examples/torch_distributed_rpca.py [--procs 4]
        [--device cpu]

Where the reference forces several host devices into one JAX process
(``XLA_FLAGS``), the port runs one process a rank: the multi-process
harness of ``repro_torch.launch.distributed`` (``distributed.multihost.
launch_workers``) starts ``--procs`` workers on this host, and each rank
along ``data`` is one of the paper's clients.  The consensus average of U
is one all-reduce a round; V_i and S_i never leave their rank.  The
workers solve the reference example's three problems: the (procs,) data
mesh on 256 x 320 at rank 8; data x model, rows split over "model" (an
even count of at least 4 ranks); and the elastic topology, 256 x 301 (a
ragged split) with Bernoulli(0.6) participation.

The ranks run on the card unless ``--device cpu`` (gloo on the CPU; ranks
sharing one card run gloo on CUDA tensors).  Without a card and without
``--device cpu`` the workers raise.
"""
from __future__ import annotations

from repro_torch.launch import distributed


def main(argv=None) -> list[str]:
    """Rank 0 prints each solve's relative error; returns every rank's
    output."""
    return distributed.main(argv)


if __name__ == "__main__":
    main()
