"""The control on the card: the plain reference computed with TF32
products, put in the program's place, comes out not correct. Needs a card:
TF32 does not exist on the CPU."""

import pytest
import torch

from benchmark import control
from benchmark.tests import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["qnet.ladder", "drqn.ladder"])
def test_tf32_control_fails_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: TF32 products exist only there")
    out = {r["mode"]: r for r in control.readings(
        cell, tiny.SEED, ["sound", "tf32"], device="cuda",
        overrides=tiny.overrides(cell))}
    assert out["sound"]["correct"]
    assert not out["tf32"]["correct"], out["tf32"]["values"]
