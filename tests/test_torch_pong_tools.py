"""CPU tests of the env-only rollout kernel's tooling and argument checks:
the instrumentation and warp marks of ``update_phases pong`` and the serve
angles the kernel takes. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from pingpong_tpu_torch import update_phases as up
from pingpong_tpu_torch.bench import rollout_env_cfg
from pingpong_tpu_torch.config import EnvConfig
from pingpong_tpu_torch.env.pong import env_params_from_config, reset
from pingpong_tpu_torch.ops import pong_kernel as tpk

KERNEL_SRC = (Path(up.__file__).resolve().parent / "csrc" /
              "pong_kernel.cu").read_text()


def test_instrumented_copy_stamps_each_step_of_the_step_loop():
    text, _ = up.instrument_pong(KERNEL_SRC)
    assert text.count(up.PONG_LOOP + " PH_STAMP(i);") == 1
    assert "ph_set" in text and "clock64()" in text
    with pytest.raises(ValueError, match="one step loop"):
        up.instrument_pong(KERNEL_SRC.replace(up.PONG_LOOP, "while (1) {"))


@pytest.mark.parametrize("tile_rows", [1, 2])
def test_warp_marks_follow_the_kernel_layout(tile_rows):
    """A warp-step is marked when some env of the warp is: a warp runs 32
    consecutive envs, one a thread."""
    params = env_params_from_config(rollout_env_cfg())
    B, steps = 512, 40
    state = reset(params, B, torch.Generator().manual_seed(3), "cpu")
    top, bot, serve = up.pong_marks(params, state, steps, 5, tile_rows)
    cells = tpk.hash_cells(B, 5, tile_rows, "cpu")
    flags = np.zeros((3, steps, B), bool)
    st = state
    for i in range(steps):
        st, _, done, hit = tpk.plain_step(params, st, i, cells, 0.02)
        flags[0, i] = (hit & (st.ball_y == 0.0)).numpy()
        flags[1, i] = (hit & (st.ball_y == 1.0)).numpy()
        flags[2, i] = done.numpy()
    want = np.zeros((3, steps, B // 32), bool)
    for env in range(B):
        want[:, :, env // 32] |= flags[:, :, env]
    for got, w in zip((top, bot, serve), want):
        assert np.array_equal(got.numpy(), w)
    assert want[0].any() and want[1].any() and want[2].any()


def test_serve_angles_the_kernel_takes():
    tpk.check_serve_angles(env_params_from_config(EnvConfig()))
    tpk.check_serve_angles(env_params_from_config(rollout_env_cfg()))
    wide = EnvConfig(ball_angle_intervals=((-60.0, -30.0), (30.0, 6e6)))
    with pytest.raises(ValueError, match="serve angles"):
        tpk.check_serve_angles(env_params_from_config(wide))
