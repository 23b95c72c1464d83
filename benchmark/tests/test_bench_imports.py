"""No module a benchmark run loads is JAX or the JAX package, compared by
whole top-level name; the reference loads nothing of the port either."""

import json
import subprocess
import sys

from benchmark import harness

RUN = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark.tests import tiny
tiny.run("qnet.ladder", seconds=0.2)
tiny.run("drqn.ladder", seconds=0.2)
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from benchmark.reference import qnet, drqn
from benchmark.tests import tiny
from benchmark import harness
for cell in ("qnet.ladder", "drqn.ladder"):
    run = harness.load_cell(cell, overrides=tiny.overrides(cell))
    ref = qnet if cell.startswith("qnet") else drqn
    ref.start(run["cfg"], tiny.SEED, "cpu")
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level(code: str):
    out = subprocess.run([sys.executable, "-c",
                          code.format(root=str(harness.ROOT))],
                         capture_output=True, text=True, check=True,
                         timeout=900)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _top_level(RUN)
    assert "pingpong_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "pingpong_tpu"}


def test_reference_loads_nothing_of_the_program():
    names = _top_level(REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "pingpong_tpu",
                        "pingpong_tpu_torch"}
