"""The port's multi-process examples (``examples/torch_distributed_rpca.py``,
``examples/torch_robust_aggregation.py``) at their smallest sizes on the
CPU: two gloo ranks each, started through the scripts' ``main(argv)``.
Held: the ranks' printed recovery errors under 1e-4, and finite losses of
both training runs (two steps say nothing about learning; the full run's
check is the script's ``--check``).
"""
import importlib.util
import math
from pathlib import Path

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", EXAMPLES / f"torch_{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_distributed_rpca():
    outs = example("distributed_rpca").main(
        ["--procs", "2", "--device", "cpu", "--m", "64", "--n", "80",
         "--rank", "4"])
    errors = [float(ln.rsplit("err=", 1)[1]) for ln in outs[0].splitlines()
              if ln.startswith(("1-D", "elastic"))]
    assert len(errors) == 2 and max(errors) < 1e-4


def test_robust_aggregation():
    losses = example("robust_aggregation").main(
        ["--procs", "2", "--device", "cpu", "--steps", "2"])
    assert len(losses["plain"]) == len(losses["robust"]) == 2
    assert all(math.isfinite(x) for x in losses["plain"] + losses["robust"])
