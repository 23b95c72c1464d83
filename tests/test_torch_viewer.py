"""PyTorch port: the viewer (``viewer/record.py``, ``render.py``,
``replay.py``, ``pygame_ui.py``), ``env/debug_render.py`` and ``cli
view``, held against the JAX package's viewer.

``record_episode`` starts from the JAX ``reset(params, key)`` state, with
the JAX nets carried over by ``qnet_from_numpy`` / ``qnet_rnn_from_numpy``;
for bot vs bot, QNet vs bot and QNetRNN vs QNet the discrete fields and
the length must be equal (as the match runner's results are in
``tests/test_torch_match.py``) and the float fields within 1e-6, the env
step's precedent (``tests/test_torch_env.py``: XLA's scalar step rounds a
last bit otherwise now and then). The frames of one trajectory must be
pixel-equal across the two packages' renderers.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pingpong_tpu.config import EnvConfig as JEnvConfig
from pingpong_tpu.checkpoint.serialize import qnet_to_dict as jqnet_to_dict
from pingpong_tpu.checkpoint.store import save_checkpoint as jsave
from pingpong_tpu.env import pong as jpong
from pingpong_tpu.evaluation import match as jm
from pingpong_tpu.evaluation.registry import ModelEntry as JEntry
from pingpong_tpu.models import qnet_init as jqnet_init
from pingpong_tpu.models import qnet_rnn_init as jrnn_init
from pingpong_tpu.viewer import record as jrecord
from pingpong_tpu.viewer import render as jrender
from pingpong_tpu_torch import cli
from pingpong_tpu_torch.checkpoint.serialize import (
    qnet_from_numpy,
    qnet_rnn_from_numpy,
)
from pingpong_tpu_torch.config import EnvConfig, ExperimentConfig
from pingpong_tpu_torch.env import pong as tpong
from pingpong_tpu_torch.evaluation import match as tm
from pingpong_tpu_torch.evaluation.registry import BOT_ID, ModelEntry
from pingpong_tpu_torch.viewer.record import record_episode
from pingpong_tpu_torch.viewer.render import FrameRenderer, render_gif

pytest.importorskip("PIL")

# the bench's tuned env: the bots rally, and every episode below ends
# inside MAX_STEPS
TUNED = dict(paddle_speed=0.03, magnus_factor=0.025, restitution=1.0,
             friction=0.6, ball_speed_range=(0.03, 0.05), spin_range=(-5, 5),
             speed_scale_every=1, speed_increment=0.1)
JENV = jpong.env_params_from_config(JEnvConfig(**TUNED))
TENV = tpong.env_params_from_config(EnvConfig(**TUNED))
MAX_STEPS = 400
BOT = ModelEntry(BOT_ID, tm.BOT, None)
RNN_DIMS = dict(feature_dim=32, lstm_hidden_dim=16, head_hidden_dim=16)


def entries(kind, seed):
    """(JAX entry, port entry) of one kind, the same weights."""
    if kind == tm.BOT:
        return JEntry(BOT_ID, jm.BOT, None), BOT
    if kind == tm.QNET:
        p = jqnet_init(jax.random.PRNGKey(seed))
        return (JEntry("q", jm.QNET, None, p),
                ModelEntry("q", tm.QNET, None,
                           qnet_from_numpy(jax.device_get(p))))
    p = jrnn_init(jax.random.PRNGKey(seed), **RNN_DIMS)
    return (JEntry("r", jm.RNN, None, p),
            ModelEntry("r", tm.RNN, None,
                       qnet_rnn_from_numpy(jax.device_get(p))))


def port_state(key):
    st = jpong.reset(JENV, key)
    return tpong.EnvState(*(torch.from_numpy(np.array(getattr(st, f)))
                            for f in tpong.EnvState._fields))


def port_record(kind_a, kind_b, seed, max_steps=MAX_STEPS):
    (ja, ta), (jb, tb) = entries(kind_a, seed), entries(kind_b, seed + 1)
    key = jax.random.PRNGKey(seed)
    want = jrecord.record_episode(JENV, ja, jb, key, max_steps=max_steps)
    got = record_episode(TENV, ta, tb, max_steps=max_steps, device="cpu",
                         state=port_state(key))
    return want, got


@pytest.mark.parametrize("kind_a,kind_b,seed", [
    (tm.BOT, tm.BOT, 6), (tm.QNET, tm.BOT, 0), (tm.RNN, tm.QNET, 4)],
    ids=["bot_vs_bot", "qnet_vs_bot", "rnn_vs_qnet"])
def test_record_episode_matches_jax(kind_a, kind_b, seed):
    want, got = port_record(kind_a, kind_b, seed)
    assert got.length == want.length > 40
    for f in dataclasses.fields(want):
        w, g = np.asarray(getattr(want, f.name)), getattr(got, f.name)
        if f.name == "length":
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, f.name
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f.name)


def test_record_episode_stops_at_the_first_done():
    # the JAX scan runs max_steps and clips; the port stops after the
    # chunk of the first done: both give one done, at the end
    _, got = port_record(tm.QNET, tm.BOT, 5, max_steps=MAX_STEPS)
    assert got.done[-1] and not got.done[:-1].any()
    assert max(got.score_a[-1], got.score_b[-1]) == JENV.max_score
    assert (got.ball_x >= 0).all() and (got.ball_x <= 1).all()
    # no done within max_steps: the whole record
    g = torch.Generator().manual_seed(0)
    short = record_episode(TENV, BOT, BOT, g, max_steps=21, device="cpu")
    assert short.length == 21 and not short.done.any()


def test_record_episode_reset_comes_from_the_generator(monkeypatch):
    g = torch.Generator().manual_seed(3)
    first = tpong.reset(TENV, 1, g)
    a = record_episode(TENV, BOT, BOT, torch.Generator().manual_seed(3),
                       max_steps=50, device="cpu")
    b = record_episode(TENV, BOT, BOT, torch.Generator().manual_seed(3),
                       max_steps=50, device="cpu", state=first)
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name),
                                      getattr(b, f.name))
    # the card unless the CPU is asked for
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        record_episode(TENV, BOT, BOT, torch.Generator(), max_steps=5)


def test_frames_pixel_equal_to_jax():
    _, traj = port_record(tm.RNN, tm.QNET, 4, max_steps=120)
    mine, theirs = FrameRenderer(), jrender.FrameRenderer()
    for t in range(traj.length):
        np.testing.assert_array_equal(
            mine.render_frame(traj, t, 0.2, 120),
            theirs.render_frame(traj, t, 0.2, 120), err_msg=f"frame {t}")
    assert mine.spin_angle == theirs.spin_angle


def test_frame_renderer_shapes():
    traj = record_episode(TENV, BOT, BOT, torch.Generator().manual_seed(1),
                          max_steps=60, device="cpu")
    frame = FrameRenderer().render_frame(traj, traj.length - 1, 0.2, 160)
    assert frame.shape == (160, 160, 3)
    assert frame.dtype == np.uint8
    assert frame.max() > 50  # something was drawn


def test_render_gif(tmp_path):
    from PIL import Image

    traj = record_episode(TENV, BOT, BOT, torch.Generator().manual_seed(2),
                          max_steps=300, device="cpu")
    out = render_gif(traj, tmp_path / "ep.gif", 0.2, size=160, every=4)
    assert Image.open(out).n_frames == len(range(0, traj.length, 4)) > 1


def test_effect_manager_spawns_and_decays_particles():
    from pingpong_tpu_torch.viewer.render import EffectManager

    m = EffectManager()
    m.add_collision(100.0, 0.0)
    # one ring + N particles
    assert m.active_count == 1 + EffectManager.N_PARTICLES
    for e in list(m.effects):
        e.update()
    # particles moved, everything still alive after one tick
    assert any(e.x != 100.0 for e in m.effects)
    for _ in range(40):
        for e in m.effects:
            e.update()
        m.effects = [e for e in m.effects if e.alive]
    assert m.active_count == 0


def test_ball_sprite_rotates_with_spin():
    """The ball sprite angle accumulates spin (the reference's
    ``test_viewer.py:282-293``): frames of a spinning ball must differ at
    the ball pixels."""
    from pingpong_tpu_torch.viewer.render import make_ball_sprite

    spr = make_ball_sprite()
    assert spr.size[0] > 8 and spr.mode == "RGBA"
    traj = record_episode(TENV, BOT, BOT, torch.Generator().manual_seed(3),
                          max_steps=50, device="cpu")
    r = FrameRenderer(ball_sprite=True)
    f1 = r.render_frame(traj, 5, 0.2, 160)
    r2 = FrameRenderer(ball_sprite=True)
    r2.spin_angle = float(r.spin_angle) + 90.0
    assert (f1 != r2.render_frame(traj, 5, 0.2, 160)).any()


def test_speed_slider_mapping():
    from pingpong_tpu_torch.viewer.pygame_ui import (
        SPEED_MAX,
        SPEED_MIN,
        SpeedSlider,
    )

    s = SpeedSlider(x=60, y=400, w=280, value=1.0)
    assert s._value_from_px(60) == SPEED_MIN
    assert abs(s._value_from_px(60 + 280) - SPEED_MAX) < 1e-9
    # round trip: handle position maps back to the value
    s.value = 2.5
    assert abs(s._value_from_px(s.handle_px()) - 2.5) < 0.05
    # clamped outside the track
    assert s._value_from_px(-100) == SPEED_MIN
    assert abs(s._value_from_px(10_000) - SPEED_MAX) < 1e-9


def jax_checkpoint(path):
    """A QNet checkpoint that the JAX package wrote."""
    jsave(path, {"params_b": jqnet_to_dict(jqnet_init(jax.random.PRNGKey(0)))})
    return str(path)


def test_run_viewer_over_a_jax_checkpoint(tmp_path, capsys):
    from PIL import Image

    from pingpong_tpu_torch.viewer.replay import run_viewer

    ckpt = jax_checkpoint(tmp_path / "m1")
    cfg = dataclasses.replace(ExperimentConfig(),
                              env=EnvConfig(render_size=120, **TUNED))
    rc = run_viewer(cfg, model_a=None, model_b=ckpt,
                    out=str(tmp_path / "v.gif"), episodes=2, seed=0,
                    max_steps=300, device="cpu")
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    lengths = [int(ln.split(": ")[1].split()[0]) for ln in lines
               if ln.startswith("[view] episode")]
    assert len(lengths) == 2
    for i, n in enumerate(lengths, 1):
        assert Image.open(tmp_path / f"v_{i}.gif").n_frames == n
    assert f"[view] wrote {tmp_path / 'v_2.gif'}" in lines


def test_cli_view_on_the_cpu(tmp_path, capsys):
    from PIL import Image

    ckpt = jax_checkpoint(tmp_path / "m1")
    rc = cli.main(["view", "--device", "cpu", "--model-b", ckpt, "--out",
                   str(tmp_path / "x.gif"), "env.render_size=120",
                   "env.max_score=1"])
    assert rc == 0
    assert Image.open(tmp_path / "x.gif").n_frames > 1
    assert "[view] episode 1:" in capsys.readouterr().out


def test_cli_view_missing_checkpoint_exits_2(tmp_path, capsys):
    rc = cli.main(["view", "--device", "cpu", "--model-b",
                   str(tmp_path / "nope"), "--out", str(tmp_path / "x.gif")])
    assert rc == 2
    assert "error: file not found" in capsys.readouterr().err


def test_debug_renderer_headless_on_a_batched_state():
    from pingpong_tpu_torch.env.debug_render import DebugRenderer
    from pingpong_tpu_torch.env.pong import observe, step_autoreset_batch
    from pingpong_tpu_torch.models.policy import ball_follower_action

    params = tpong.env_params_from_config(EnvConfig())
    g = torch.Generator().manual_seed(0)
    state = tpong.reset(params, 4, g)
    r = DebugRenderer(0.2, size=160, window=False)
    frames = []
    for _ in range(5):
        obs_a, obs_b = observe(state)
        state, _ = step_autoreset_batch(params, state, g,
                                        ball_follower_action(obs_a),
                                        ball_follower_action(obs_b), 64)
        frames.append(r.render(state, index=1))
    assert frames[0].shape == (160, 160, 3)
    # consecutive frames differ (the ball moves)
    assert any(not np.array_equal(frames[i], frames[i + 1])
               for i in range(4))
    # env 1 of the batch is what was drawn: the JAX renderer agrees
    jr = jrender.FrameRenderer()
    one = {f: getattr(state, f)[1:2] for f in (
        "ball_x", "ball_y", "ball_vx", "ball_vy", "spin", "top_paddle_x",
        "bottom_paddle_x", "score_a", "score_b")}
    fresh = DebugRenderer(0.2, size=160, window=False)
    got = fresh.render(tpong.EnvState(**one, bounce_count=None, t=None,
                                      done=None), index=0)
    traj = jrecord.Trajectory(**{f: v.numpy() for f, v in one.items()},
                              action_a=None, action_b=None, done=None,
                              length=1)
    np.testing.assert_array_equal(got, jr.render_frame(traj, 0, 0.2, 160))
    r.close()
