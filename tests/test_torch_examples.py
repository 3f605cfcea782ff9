"""The port's single-process examples (``examples/torch_*.py``) at their
smallest sizes on the CPU, each through its ``main(argv)`` in this
process, with the plain versions (the multi-process ones:
``tests/test_torch_examples_ranks.py``).

Each script asserts what its reference counterpart asserts (the
quickstart's recovery error under 1e-4); here also the serving tenants'
errors under 1e-4, a finite training loss, and the training example's
parameter count equal to the reference's for the same config.
"""
import importlib.util
import math
from pathlib import Path

import pytest

from repro.configs import get_config as jget_config
from repro.models import get_model as jget_model
from repro.models import params as jparams

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", EXAMPLES / f"torch_{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quickstart(capsys):
    out = example("quickstart").main(["--device", "cpu", "--n", "120",
                                       "--rank", "6", "--clients", "4"])
    assert out["error"] < 1e-4 and out["convex_error"] < 1e-4
    assert out["auto_method"] == "ialm"
    assert 0 < out["early_rounds"] <= 100 and out["warm_rounds"] >= 1
    assert "warm refresh:" in capsys.readouterr().out


def test_rpca_serving():
    out = example("rpca_serving").main(["--device", "cpu", "--size", "80",
                                         "--rank", "4"])
    assert len(out["errors"]) == 10
    assert max(out["errors"]) < 1e-4 and out["direct_error"] < 1e-4


def test_train_lm(capsys):
    mod = example("train_lm")
    out = mod.main(["--tiny", "--steps", "2", "--device", "cpu"])
    tiny = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                vocab=2048)
    jcfg = jget_config("tinyllama-1.1b").replace(
        name="llama-100m", n_layers=8, d_model=768, n_heads=12,
        n_kv_heads=4, d_ff=2048, vocab=32000).replace(**tiny)
    assert out["params"] == jparams.count_params(jget_model(jcfg).specs())
    assert math.isfinite(out["final_loss"])
    assert f"{out['params'] / 1e6:.1f}M params" in capsys.readouterr().out


def test_examples_raise_without_a_card_unless_asked_for_the_cpu():
    """As every entry point: no card and no ``--device cpu`` raises."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example("train_lm").main(["--tiny", "--steps", "1"])
