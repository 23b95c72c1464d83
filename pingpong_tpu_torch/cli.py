"""Command-line interface of the PyTorch port.

    python -m pingpong_tpu_torch.cli train --config configs/qnet.yaml \\
        dqn.save_latest_checkpoint_interval_steps=0
    python -m pingpong_tpu_torch.cli train-rnn --config configs/rnn.yaml \\
        drqn.save_latest_checkpoint_interval_steps=0
    python -m pingpong_tpu_torch.cli bench

Runs on the CUDA card by default; ``--device cpu`` runs the kernels' plain
PyTorch versions instead (tests, tiny shapes). Dotted ``key=value``
overrides apply to the YAML config as in the JAX package's CLI.
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


def _run(trainer_fn, log_name, args) -> int:
    from pingpong_tpu_torch.utils.metrics import MetricsLogger

    logger = MetricsLogger(log_path=f"{args.workdir}/{log_name}")
    try:
        records = trainer_fn(logger).run()
    finally:
        logger.close()
    promoted = sum(1 for r in records if r.promoted)
    print(f"done: {promoted}/{len(records)} generations promoted")
    return 0


def cmd_train(args) -> int:
    cfg = _load(args)
    from pingpong_tpu_torch.selfplay.loop import QNetSelfPlay

    return _run(lambda logger: QNetSelfPlay(
        cfg.env, cfg.dqn, workdir=args.workdir, seed=cfg.seed, logger=logger,
        device=args.device), "train_qnet_metrics.jsonl", args)


def cmd_train_rnn(args) -> int:
    cfg = _load(args)
    from pingpong_tpu_torch.selfplay.loop_rnn import DRQNSelfPlay

    return _run(lambda logger: DRQNSelfPlay(
        cfg.env, cfg.drqn, workdir=args.workdir, seed=cfg.seed, logger=logger,
        device=args.device), "train_rnn_metrics.jsonl", args)


def cmd_bench(args) -> int:
    from pingpong_tpu_torch import bench

    bench.run(args.device, args.rollout_windows, args.iteration_windows,
              args.trials)
    return 0


def main(argv=None) -> int:
    from pingpong_tpu_torch import bench

    parser = argparse.ArgumentParser(prog="pingpong-tpu-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name, fn, help_ in (("train", cmd_train, "QNet self-play training"),
                            ("train-rnn", cmd_train_rnn,
                             "DRQN (LSTM) self-play training")):
        p = sub.add_parser(name, help=help_)
        p.add_argument("--config", default=None, help="YAML config path")
        p.add_argument("--workdir", default=".", help="directory for outputs")
        p.add_argument("--seed", type=int, default=None,
                       help="override the config seed")
        p.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu")
        p.add_argument("overrides", nargs="*", default=[],
                       help="dotted config overrides, e.g. dqn.num_envs=8192")
        p.set_defaults(fn=fn)
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
