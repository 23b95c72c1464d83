"""Typed configuration tree (a copy of the JAX package's schema).

One dataclass per config block, covering every key of the reference's two
YAML files (``config.yaml:1-41`` and
``config_rnn.yaml:6-91``) plus the TPU-specific scaling
knobs the reference does not have (env batch size, rollout chunk length,
updates-per-iteration, mesh axes). Field defaults for :class:`EnvConfig`
mirror the reference env's constructor defaults
(``envs/my_pong_env_2p.py:19-39``); the shipped YAMLs under
``configs/`` mirror the reference's tuned values.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass
class EnvConfig:
    """Two-player Pong environment parameters."""

    render_size: int = 400          # viewer only; physics is on the unit square
    paddle_width: float = 0.2
    paddle_speed: float = 0.02
    max_score: int = 3
    enable_render: bool = False     # viewer only

    enable_spin: bool = True
    magnus_factor: float = 0.01
    restitution: float = 0.9
    friction: float = 0.2
    ball_mass: float = 1.0
    world_ball_radius: float = 0.03

    ball_speed_range: Tuple[float, float] = (0.01, 0.05)
    spin_range: Tuple[float, float] = (-10.0, 10.0)
    ball_angle_intervals: Tuple[Tuple[float, float], Tuple[float, float]] = (
        (-60.0, -30.0),
        (30.0, 60.0),
    )

    speed_scale_every: int = 3
    speed_increment: float = 0.2

    # TPU-framework addition: hard step cap per episode so batched rollouts
    # and eval matches are guaranteed to terminate under jit. 0 = disabled.
    max_episode_steps: int = 0


@dataclass
class SelfPlayConfig:
    """Generation-promotion loop shared by both trainer families.

    Semantics follow scripts/train_iterative.py:210-297 and
    train_rnn_iterative.py:707-898: learner B challenges frozen A; B is
    promoted when its eval win rate vs A AND vs the opponent pool both clear
    their thresholds; after ``max_retries_for_generation`` failed tries the
    generation is checkpointed as ``_fault``, B is reset, and the generation
    counts as done anyway.
    """

    max_generations: int = 8
    episodes_per_generation: int = 2400
    eval_episodes: int = 1000
    max_retries_for_generation: int = 12
    curr_win_threshold: float = 0.61
    pool_win_threshold: float = 0.61
    opponent_pool_ratio: float = 0.33
    # Parity-only knob: present (and equally unused) in the reference
    # (config.yaml:28 — nothing reads it). Kept so reference
    # YAML files load unchanged; no code consumes it.
    min_pool_generation: int = 2
    win_rate_interval: int = 400
    # Side-balanced promotion gates (no reference equivalent): evaluate the
    # learner over N/2 games per seating instead of always on the favored
    # bottom seat (the spin/mirror quirk, tests/test_side_asymmetry.py).
    # False = reference-parity single-seat gates.
    swap_sides_eval: bool = False
    # Reference stale-noise quirk (train_iterative.py:86-104): modelA is
    # left in train mode, so frozen A plays the WHOLE generation with the
    # one noise draw its checkpoint carried. True reproduces that: one
    # noise draw per generation is folded into A's noisy heads
    # (models/qnet.py::qnet_fold_noise) for training rollouts and gate
    # evals; the promoted checkpoint stays clean. False (default) = the
    # NoisyNet-standard mu-greedy frozen policy. Quantified in
    # demo_fidelity/ (QNet family only).
    frozen_a_stale_noise: bool = False


@dataclass
class DQNConfig:
    """Feed-forward NoisyNet dueling DQN trainer (train_iterative.py analog)."""

    selfplay: SelfPlayConfig = field(default_factory=SelfPlayConfig)

    lr: float = 0.00025
    gamma: float = 0.99
    batch_size: int = 256
    memory_size: int = 1_000_000
    epsilon_decay: float = 0.995
    min_epsilon: float = 0.02
    target_update_interval: int = 1000
    # Soft (Polyak) target updates: target <- target + tau*(online-target)
    # after EVERY update instead of the reference's hard copy every
    # target_update_interval steps. 0.0 = reference-parity hard sync.
    # A learning-dynamics knob for from-scratch ladders, where hard syncs
    # make the promotion gate luck-sensitive (ROADMAP item 3).
    target_tau: float = 0.0

    # PER (train_iterative.py:49-76, 113-114)
    per_alpha: float = 0.6
    per_beta_start: float = 0.4
    per_beta_frames: int = 100_000
    per_eps: float = 1e-6

    # Reference trains only the noisy dueling heads, features frozen
    # (train_iterative.py:96-104).
    train_heads_only: bool = True

    model_id: int = 5
    init_model_path: Optional[str] = None
    ckpt_dir: str = "checkpoints"
    plot_dir: str = "plot"
    # Full-train-state autosave (PER buffer included) every N train steps,
    # restored as tier 0 on startup for mid-generation crash resume. The
    # reference QNet trainer has no such autosave (only the RNN one does,
    # train_rnn_iterative.py:630-667); 0 disables.
    save_latest_checkpoint_interval_steps: int = 10_000
    latest_checkpoint_filename: str = "latest_qnet_training_state"
    # Async autosave (SURVEY §5): the periodic full-state save snapshots
    # on device (one jitted copy, sub-ms stall) and serializes + writes on
    # a worker thread, off the train loop's critical path. False = the
    # synchronous Orbax write (stalls the loop for the full serialize).
    async_autosave: bool = True
    # Retention/GC (framework addition; reference keeps every checkpoint
    # forever): newest N promoted / fault checkpoints to keep, 0 = keep
    # all. The latest autosave and the init_model_path are never deleted.
    keep_checkpoints: int = 0
    keep_fault_checkpoints: int = 0

    # ---- scaling knobs (no reference equivalent) ----
    # The schema is shared field-for-field with the JAX package so that
    # its YAML files load unchanged. In the PyTorch port the rollout
    # (use_pallas_rollout), the gate evals (use_pallas_eval) and the
    # update block (use_pallas_update) each run as one hand-written CUDA
    # kernel (pingpong_tpu_torch/csrc/). With use_pallas_rollout false the
    # rollout is a scan of PyTorch ops; with use_pallas_update false, or
    # shapes outside ops/dqn_update.py::supports_fused_update, the update
    # is autodiff over the row replay layout (train/dqn.py::dqn_route).
    use_pallas_rollout: bool = True
    use_pallas_eval: bool = True
    use_pallas_update: bool = True
    pallas_tile_rows: int = 2048    # envs per kernel program (mult. of 128
                                    # on TPU; capped at num_envs)
    pallas_member_groups: int = 2   # lane groups per tile for the masked
                                    # opponent pass (pool tax ~ span/G;
                                    # 1 = whole-tile member loop)
    # Pool-opponent binding policy on the fused rollout path:
    #   "bucketed" (default) — envs are statically partitioned into
    #     contiguous lane buckets sized by the opponent probabilities
    #     ((1-ratio) of envs vs A, the rest split evenly over the pool);
    #     an env re-binds to its bucket's member when its episode ends.
    #     Sort-free: no per-chunk argsort/gather, and every kernel tile
    #     spans <= 2 members regardless of pool size. Distributional
    #     claim, stated precisely: the PER-ENV (and per-step) opponent
    #     marginal equals the reference's iid draw
    #     (train_iterative.py:235-236) exactly; the EPISODE-level mixture
    #     can deviate, because with a fixed env->member binding each
    #     member's share of completed episodes is weighted by its envs'
    #     episode-completion rate, which correlates with opponent
    #     strength (shorter games vs a member => more episodes vs it).
    #     Also zero variance in per-member env counts (stratified, not
    #     iid). Learning-dynamics A/B vs "sorted": demo_fidelity/.
    #     When the pool bucket span has fewer env lanes than live pool
    #     members (which would starve the lane-less members under a
    #     fixed map), the member offset ROTATES per chunk so every
    #     member is reached over successive chunks, uniform in time
    #     average (train/dqn.py::bucket_opp_idx phase; round 5 — the
    #     round-4 fall-back-to-"sorted" could only see the padded
    #     pool_max and fired spuriously).
    #   "sorted" — iid per-episode draws (the reference's exact joint
    #     distribution); envs are argsorted by bound member each chunk.
    opponent_binding: str = "bucketed"
    # Multi-chip learner layout over the mesh's data axis:
    #   "replicated" — every chip keeps the full replay ring and runs the
    #     identical fused update block; the rollout chunk is all-gathered
    #     once per iteration. Zero collectives on the serial update
    #     chain, bit-equal to single-chip; per-chip update cost and
    #     replay HBM do NOT shrink with chip count and the all-gather
    #     grows linearly with it.
    #   "sharded" — the replay ring, priority planes, and update compute
    #     shard over 'data': each chip keeps only its own envs'
    #     experience (no all-gather), samples batch_size/n rows per
    #     update from its LOCAL PER distribution (stratified proposal
    #     P(i) = (1/n) p_i^a / mass_shard with the exact importance
    #     weight — see train/dqn.py::_push_update_sharded), and one
    #     psum+pmax round per update synchronizes the replicated Adam
    #     step. Per-chip update FLOPs and replay HBM scale ~1/n;
    #     per-update collective cost is constant in n.
    #   "auto" (default) — "replicated" up to 16 chips (the fused-block
    #     latency advantage dominates), "sharded" above (the all-gather
    #     crossover; cost model in docs/PODRUN.md).
    # The PyTorch port runs one device: "sharded" warns, as the JAX
    # learner does with one data shard, and runs the single-device
    # learner; the multi-device layouts are not ported yet (ROADMAP.md).
    learner_sharding: str = "auto"
    num_envs: int = 4096            # lockstep env batch, sharded over 'data'
    rollout_length: int = 64        # env steps per jitted iteration
    updates_per_iteration: int = 64 # SGD steps per iteration; ref does 1 SGD
                                    # step per (single-env) env step, so
                                    # updates/env-step = upd/(T*B) is the
                                    # fidelity knob (train_iterative.py:244)
    pool_max: int = 16              # static opponent-pool capacity

    # ---- Rainbow (Hessel et al. 2018, arXiv:1710.02298) ----
    # "qnet" (default) trains the QNet above on the routes of
    # train/dqn.py; "rainbow" trains Rainbow's distributional noisy
    # dueling net (models/rainbow.py) with its own learner
    # (train/rainbow.py: scan rollout, n-step rows in the row PER, the
    # distributional Double-DQN update with kernel 6) on the same loop,
    # env and gates (configs/rainbow.yaml). The keys below are read by the
    # Rainbow learner alone; the QNet's use_pallas_* knobs do not apply to
    # it.
    agent: str = "qnet"
    num_atoms: int = 51             # atoms of the value distribution
    v_min: float = -10.0            # support [v_min, v_max]
    v_max: float = 10.0
    n_step: int = 3                 # multi-step return length
    stream_hidden: int = 512        # units of each dueling stream
    noisy_sigma0: float = 0.5       # noisy sigma init sigma0/sqrt(fan_in)
    adam_eps: float = 1.5e-4        # Adam's epsilon (the QNet's is 1e-8)


@dataclass
class DRQNConfig:
    """Recurrent (LSTM) DRQN trainer (train_rnn_iterative.py analog)."""

    selfplay: SelfPlayConfig = field(
        default_factory=lambda: SelfPlayConfig(
            max_generations=5,
            episodes_per_generation=3000,
            eval_episodes=500,
            max_retries_for_generation=10,
            curr_win_threshold=0.60,
            pool_win_threshold=0.60,
            opponent_pool_ratio=0.4,
            win_rate_interval=500,
        )
    )

    # Architecture (config_rnn.yaml:38-42)
    feature_dim: int = 128
    lstm_hidden_dim: int = 128
    lstm_layers: int = 1
    head_hidden_dim: int = 128

    trace_length: int = 8
    burn_in_length: int = 0         # scaffolded in the reference, disabled by
                                    # default (train_rnn_iterative.py:431-448)

    lr: float = 0.0001
    gamma: float = 0.99
    batch_size: int = 64
    memory_size: int = 200_000      # episodes (reference deque capacity)
    min_episodes_for_training_start: int = 10
    initial_epsilon_per_generation: float = 1.0
    epsilon_decay: float = 0.999
    min_epsilon: float = 0.05
    target_update_interval: int = 2000
    # Soft (Polyak) target updates, as in DQNConfig. 0.0 = hard sync.
    # tau > 0 disables the batched target-Q precompute (the target then
    # evolves every update), costing ~2x update-block time.
    target_tau: float = 0.0
    max_episode_steps: int = 1000
    grad_clip_norm: float = 1.0

    model_id_prefix: str = "rnn_pong_soul_"
    init_model_path_rnn: Optional[str] = None
    ckpt_dir_rnn: str = "checkpoints_rnn"
    plot_dir_rnn: str = "plot_rnn"
    save_latest_checkpoint_interval_steps: int = 10_000
    latest_checkpoint_filename: str = "latest_rnn_training_state"
    # Async autosave — see DQNConfig.async_autosave.
    async_autosave: bool = True
    # Retention/GC, as in DQNConfig (0 = keep all, reference parity).
    keep_checkpoints: int = 0
    keep_fault_checkpoints: int = 0

    # ---- TPU scaling knobs ----
    # Fused recurrent actor-rollout (ops/recurrent_rollout.py, kernel 3):
    # whole chunk in one launch with both LSTM streams on chip. Applies
    # when the architecture is the reference's shipped one (lstm_layers=1,
    # shared head, dims <= 128); other architectures, or false, take the
    # scan rollout of PyTorch ops (train/drqn.py::drqn_route).
    use_pallas_rollout: bool = True
    # Fused no-transitions eval streaming through the recurrent kernel
    # (promotion gates; single-seat and side-balanced), as in DQNConfig;
    # nets of another architecture gate through the match runner.
    use_pallas_eval: bool = True
    # Fused update block (ops/drqn_update.py, kernel 4): all K SGD steps
    # in one launch with a hand-derived LSTM BPTT, for the kernel
    # architecture without burn-in and, on the card, a batch_size that is
    # a multiple of 4 (the CPU's plain version takes any). Otherwise, or
    # false, the update is autodiff (train/drqn.py::drqn_route).
    use_pallas_update: bool = True
    pallas_tile_rows: int = 512     # envs per kernel program (mult. of 128
                                    # on TPU; capped at num_envs)
    pallas_steps_per_cell: int = 8  # rollout grid-kernel inner unroll
                                    # (multiple of 8; divides rollout_length;
                                    # a TPU grid knob the port ignores)
    # Pool-opponent binding on the fused rollout path ("bucketed" |
    # "sorted") — see DQNConfig.opponent_binding. For the recurrent
    # trainer "bucketed" additionally removes the canonical-order
    # un-permute of the whole transition chunk (the sequence ring is
    # per-env), which the sorted path pays every iteration.
    opponent_binding: str = "bucketed"
    # Multi-chip learner layout ("replicated" | "sharded" | "auto") —
    # see DQNConfig.learner_sharding. For the recurrent trainer the
    # sharded mode keeps each chip's sequence ring local to its own envs
    # (no chunk all-gather, ring HBM ~1/n), samples batch_size/n windows
    # per update from the local ring (exact: the global window-uniform
    # rule is uniform over envs, and envs split evenly over shards —
    # stratification is bias-free), and runs one grad psum per update
    # with the masked-mean numerator/denominator reduced globally.
    # Requires episode_uniform_sampling=False (the episode directory is
    # global bookkeeping; sharded mode falls back to "replicated" with a
    # warning when the knob is on).
    learner_sharding: str = "auto"
    num_envs: int = 1024
    rollout_length: int = 128
    updates_per_iteration: int = 32
    pool_max: int = 16
    # Device sequence buffer is a fixed-shape per-env time ring of
    # ring_len columns (reference stores ragged episodes in host RAM);
    # capacity in transitions = num_envs * ring_len.
    ring_len: int = 4096
    # Parity knob: sample traces episode-uniform-then-offset-uniform as
    # the reference does (train_rnn_iterative.py:129-144, over-weighting
    # short episodes) instead of the default window-uniform rule. Needs
    # an episode directory in the buffer (episode_dir_capacity slots; a
    # too-small directory only raises sample rejection, never corrupts).
    episode_uniform_sampling: bool = False
    episode_dir_capacity: int = 65536


@dataclass
class MeshConfig:
    """Device-mesh / sharding layout."""

    data_axis: str = "data"         # env batch + replay shards
    model_axis: str = "model"       # reserved (nets are tiny; spec-level only)
    num_data: int = -1              # -1: all devices
    num_model: int = 1


@dataclass
class ExperimentConfig:
    env: EnvConfig = field(default_factory=EnvConfig)
    dqn: DQNConfig = field(default_factory=DQNConfig)
    drqn: DRQNConfig = field(default_factory=DRQNConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    seed: int = 0


def _from_dict(cls, data):
    """Recursively build a dataclass from a (possibly partial) dict."""
    if data is None:
        return cls()
    if not dataclasses.is_dataclass(cls):
        return data
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise KeyError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    for name, f in fields.items():
        if name not in data:
            continue
        value = data[name]
        ftype = f.type
        # Nested dataclass blocks are declared directly by their class.
        nested = _NESTED.get((cls.__name__, name))
        if nested is not None and isinstance(value, dict):
            kwargs[name] = _from_dict(nested, value)
        elif name == "ball_angle_intervals" and value is not None:
            kwargs[name] = tuple(tuple(float(x) for x in iv) for iv in value)
        elif name in ("ball_speed_range", "spin_range") and value is not None:
            kwargs[name] = tuple(float(x) for x in value)
        else:
            kwargs[name] = value
    base = cls()
    return dataclasses.replace(base, **kwargs)


_NESTED = {
    ("ExperimentConfig", "env"): EnvConfig,
    ("ExperimentConfig", "dqn"): DQNConfig,
    ("ExperimentConfig", "drqn"): DRQNConfig,
    ("ExperimentConfig", "mesh"): MeshConfig,
    ("DQNConfig", "selfplay"): SelfPlayConfig,
    ("DRQNConfig", "selfplay"): SelfPlayConfig,
}


def experiment_from_dict(data: dict) -> ExperimentConfig:
    return _from_dict(ExperimentConfig, data)
