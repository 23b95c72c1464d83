"""Command-line interface of the PyTorch port.

    python -m pingpong_tpu_torch.cli train        --config configs/qnet.yaml
    python -m pingpong_tpu_torch.cli train        --config configs/rainbow.yaml
    python -m pingpong_tpu_torch.cli train-rnn    --config configs/rnn.yaml
    python -m pingpong_tpu_torch.cli round-robin  --ckpt-dir checkpoints --out results_round_robin
    python -m pingpong_tpu_torch.cli arena        --ckpt-dir checkpoints_rnn --db arena_database.json
    python -m pingpong_tpu_torch.cli bench
    python -m pingpong_tpu_torch.cli view         --model-b checkpoints/model5-1
    python -m pingpong_tpu_torch.cli import-torch model.pth checkpoints/model

Runs on the CUDA card by default; ``--device cpu`` runs the kernels' plain
PyTorch versions instead (tests, tiny shapes). ``view --live`` plays on
the host (the C++ engine and numpy forwards), as in the JAX package, and
``import-torch`` only converts files. Dotted ``key=value``
overrides apply to the YAML config as in the JAX package's CLI. A second
``train`` or ``train-rnn`` in the same workdir resumes from the full-state
autosave. After training the reward (and gate) plots are drawn; a plot
that fails prints a warning and the command still succeeds.

``--distributed`` joins the process group that torchrun describes (one
process a card; gloo for ``--device cpu``) before anything is built:

    torchrun --nproc-per-node N -m pingpong_tpu_torch.cli train --distributed ...

``train`` and ``train-rnn`` then run data-parallel over the ranks and rank
0 alone writes the log, the checkpoints and the plots; the tournaments and
the viewer run on rank 0 alone.

``train --trace`` and ``train-rnn --trace`` turn the program's tracer on
(``utils/trace.py``) and write one ``spans`` record into the metrics JSONL
at each gate: for each span name its count, total and self seconds over
the try, with the counters and the kernels' launches (the records are
drained, so memory stays bounded over a long run).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from pingpong_tpu_torch.config import apply_overrides, load_config


def _load(args):
    cfg = apply_overrides(load_config(args.config), args.overrides)
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, seed=args.seed)
    return cfg


def _distributed_setup(args) -> bool:
    """``--distributed``: join the process group before anything is built
    (gloo for ``--device cpu``, else the backend of the card). Returns True
    on the process that writes (rank 0, or a single process)."""
    from pingpong_tpu_torch.parallel.mesh import (
        initialize_distributed,
        is_coordinator,
    )

    if args.distributed:
        initialize_distributed(
            backend="gloo" if args.device == "cpu" else None)
    return is_coordinator()


def _run(trainer_fn, log_name, args):
    """Build the trainer and run it. Returns ``(driver, records)``, or
    None on a rank that does not write."""
    from pingpong_tpu_torch.utils.metrics import MetricsLogger

    writer = _distributed_setup(args)
    if args.trace:
        from pingpong_tpu_torch.utils import trace

        trace.enable()
    logger = MetricsLogger(
        log_path=f"{args.workdir}/{log_name}" if writer else None,
        echo=writer)
    try:
        driver = trainer_fn(logger)
        records = driver.run()
    finally:
        logger.close()
    if not writer:
        return None
    promoted = sum(1 for r in records if r.promoted)
    print(f"done: {promoted}/{len(records)} generations promoted")
    return driver, records


def _plots(draw) -> None:
    try:
        draw()
    except Exception as e:  # plotting must never fail the run
        print(f"[warn] plot failed: {e}", file=sys.stderr)


def cmd_train(args) -> int:
    cfg = _load(args)
    agent = cfg.dqn.agent
    if agent == "qnet":
        from pingpong_tpu_torch.selfplay.loop import QNetSelfPlay as loop
    elif agent == "rainbow":
        from pingpong_tpu_torch.selfplay.loop_rainbow import (
            RainbowSelfPlay as loop,
        )
    else:
        raise ValueError(f"unknown dqn.agent {agent!r} (qnet or rainbow)")

    ran = _run(lambda logger: loop(
        cfg.env, cfg.dqn, workdir=args.workdir, seed=cfg.seed, logger=logger,
        device=args.device, mesh_cfg=cfg.mesh, log_spans=args.trace),
        f"train_{agent}_metrics.jsonl", args)
    if ran is None:
        return 0
    driver, records = ran

    def draw():
        from pingpong_tpu_torch.utils.plotting import (
            plot_reward_history,
            plot_selfplay_records,
        )

        plot_dir = f"{args.workdir}/{cfg.dqn.plot_dir}"
        plot_selfplay_records(records, f"{plot_dir}/generation_gates.png")
        plot_reward_history(
            driver.reward_history,
            f"{plot_dir}/training_iterative_rewards.png",
            title=f"{'Rainbow' if agent == 'rainbow' else 'QNet'} "
                  "self-play: mean episode reward (B)")

    _plots(draw)
    return 0


def cmd_train_rnn(args) -> int:
    cfg = _load(args)
    from pingpong_tpu_torch.selfplay.loop_rnn import DRQNSelfPlay

    ran = _run(lambda logger: DRQNSelfPlay(
        cfg.env, cfg.drqn, workdir=args.workdir, seed=cfg.seed, logger=logger,
        device=args.device, mesh_cfg=cfg.mesh, log_spans=args.trace),
        "train_rnn_metrics.jsonl", args)
    if ran is None:
        return 0
    driver, _ = ran

    def draw():
        from pingpong_tpu_torch.utils.plotting import plot_reward_history

        plot_reward_history(
            driver.reward_history,
            f"{args.workdir}/{cfg.drqn.plot_dir_rnn}/training_rnn_rewards.png",
            title="DRQN self-play: mean episode reward (B)")

    _plots(draw)
    return 0


def cmd_round_robin(args) -> int:
    cfg = _load(args)
    if not _distributed_setup(args):
        return 0
    from pingpong_tpu_torch.evaluation.round_robin import run_round_robin

    return run_round_robin(
        cfg, ckpt_dir=args.ckpt_dir, out_dir=args.out,
        episodes_per_match=args.episodes, include_bot=not args.no_bot,
        seed=cfg.seed, swap_sides=args.swap_sides, device=args.device)


def cmd_arena(args) -> int:
    cfg = _load(args)
    if not _distributed_setup(args):
        return 0
    from pingpong_tpu_torch.evaluation.arena import run_arena

    return run_arena(
        cfg, ckpt_dir=args.ckpt_dir, db_path=args.db, out_dir=args.out,
        episodes_per_match=args.episodes, include_bot=not args.no_bot,
        seed=cfg.seed, swap_sides=args.swap_sides,
        save_every=args.save_every, device=args.device)


def cmd_view(args) -> int:
    cfg = _load(args)
    if not _distributed_setup(args):
        return 0
    if args.live:
        # real-time match on the native C++ engine + host numpy policies
        # (no accelerator on the frame loop)
        from pingpong_tpu_torch.selfplay.pool import load_params_any
        from pingpong_tpu_torch.viewer.live import play_live

        params_a = load_params_any(args.model_a) if args.model_a else None
        params_b = load_params_any(args.model_b) if args.model_b else None
        play_live(cfg.env, params_a, params_b, episodes=args.episodes,
                  seed=cfg.seed, size=cfg.env.render_size)
        return 0
    from pingpong_tpu_torch.viewer.replay import run_viewer

    return run_viewer(cfg, model_a=args.model_a, model_b=args.model_b,
                      out=args.out, episodes=args.episodes,
                      interactive=args.interactive, seed=cfg.seed,
                      device=args.device)


def cmd_import_torch(args) -> int:
    import os

    from pingpong_tpu_torch.tools.import_torch import (
        import_torch_checkpoint,
        import_torch_dir,
    )

    if os.path.isdir(args.src):
        results = import_torch_dir(args.src, args.dst)
        ok = sum(1 for v in results.values() if v)
        print(f"imported {ok}/{len(results)} checkpoints into {args.dst}")
        return 0 if ok else 1
    out = import_torch_checkpoint(args.src, args.dst)
    print(f"imported {args.src} -> {out}")
    return 0


def cmd_bench(args) -> int:
    from pingpong_tpu_torch import bench

    bench.run(args.device, args.rollout_windows, args.iteration_windows,
              args.trials)
    return 0


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", default=None, help="YAML config path")
    p.add_argument("--workdir", default=".", help="directory for outputs")
    p.add_argument("--seed", type=int, default=None,
                   help="override the config seed")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument(
        "--distributed", action="store_true",
        help="one process a card under torchrun: join the process group "
             "before anything is built; rank 0 alone writes checkpoints, "
             "logs and plots")
    p.add_argument("overrides", nargs="*", default=[],
                   help="dotted config overrides, e.g. dqn.num_envs=8192")


def _add_tournament(p: argparse.ArgumentParser) -> None:
    p.add_argument("--ckpt-dir", default="checkpoints",
                   help="checkpoint dir (relative to CWD, not --workdir)")
    p.add_argument("--episodes", type=int, default=100)
    p.add_argument("--no-bot", action="store_true")
    p.add_argument("--swap-sides", action="store_true",
                   help="side-balanced: half the games per seating")


def main(argv=None) -> int:
    from pingpong_tpu_torch import bench

    parser = argparse.ArgumentParser(prog="pingpong-tpu-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name, fn, help_ in (("train", cmd_train, "QNet (or, by dqn.agent, "
                             "Rainbow) self-play training"),
                            ("train-rnn", cmd_train_rnn,
                             "DRQN (LSTM) self-play training")):
        p = sub.add_parser(name, help=help_)
        _add_common(p)
        p.add_argument(
            "--trace", action="store_true",
            help="turn the tracer on and log a 'spans' record (time by "
                 "span name, counters) into the metrics JSONL at each gate")
        p.set_defaults(fn=fn)

    p = sub.add_parser("round-robin",
                       help="all-pairs tournament over checkpoints")
    _add_common(p)
    _add_tournament(p)
    p.add_argument("--out", default="results_round_robin")
    p.set_defaults(fn=cmd_round_robin)

    p = sub.add_parser("arena", help="persistent resumable tournament")
    _add_common(p)
    _add_tournament(p)
    p.add_argument("--db", default="arena_database.json")
    p.add_argument("--out", default="results_arena")
    p.add_argument("--save-every", type=int, default=0,
                   help="save the DB every N episodes (crash granularity; "
                        "1 = reference per-episode saves, 0 = per batch)")
    p.set_defaults(fn=cmd_arena)

    p = sub.add_parser("view",
                       help="render an episode between two checkpoints")
    _add_common(p)
    p.add_argument("--model-a", default=None,
                   help="checkpoint path (default: bot)")
    p.add_argument("--model-b", default=None,
                   help="checkpoint path (default: bot)")
    p.add_argument("--out", default="view.gif")
    p.add_argument("--episodes", type=int, default=1)
    p.add_argument("--interactive", action="store_true", help="pygame window")
    p.add_argument(
        "--live", action="store_true",
        help="real-time pygame match on the native C++ engine "
             "(host inference, no accelerator)")
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser(
        "import-torch",
        help="convert reference .pth checkpoints to the native format")
    p.add_argument("src", help=".pth file or a directory of .pth files")
    p.add_argument("dst",
                   help="output checkpoint dir (or parent dir for batches)")
    p.set_defaults(fn=cmd_import_torch)

    p = sub.add_parser("bench", help="headline bench: env-steps/s of the "
                       "env-only rollouts and the train iterations")
    bench.add_arguments(p)
    p.set_defaults(fn=cmd_bench)
    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"error: file not found: {e.filename or e}", file=sys.stderr)
        return 2
    except KeyError as e:
        print(f"error: {e.args[0] if e.args else e}", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
