"""Gloo CPU processes for the port's multi-rank tests.

``run_ranks(case, n, tmp_path, payload)`` starts ``n`` processes of this
module (``python -m tests.torch_dist CASE RANK N PORT DIR``), each joins a
gloo process group over ``localhost``, runs ``CASES[case](payload)`` and
writes its result to ``DIR/result_RANK.pt``; the results come back in rank
order. The workers import the port and torch only (no JAX), so the JAX
side of a comparison runs in the test's own process.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import torch

from pingpong_tpu_torch.parallel.mesh import free_port

REPO = Path(__file__).resolve().parent.parent


def worker_env(threads: int = 1) -> dict:
    env = dict(os.environ)
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS=str(threads),
               MKL_NUM_THREADS=str(threads))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return env


def wait_all(procs, timeout):
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    return outs


def run_ranks(case: str, n: int, tmp_path, payload=None, timeout=300):
    d = Path(tmp_path) / f"ranks_{case}_{n}"
    d.mkdir(parents=True, exist_ok=True)
    torch.save(payload, d / "payload.pt")
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_dist", case, str(r), str(n),
         str(port), str(d)], env=worker_env(), cwd=str(REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    wait_all(procs, timeout)
    return [torch.load(d / f"result_{r}.pt", weights_only=False)
            for r in range(n)]


# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------

def _configs(payload):
    from pingpong_tpu_torch.config.schema import (
        DQNConfig,
        DRQNConfig,
        EnvConfig,
        SelfPlayConfig,
    )

    cls = DQNConfig if payload["kind"] == "dqn" else DRQNConfig
    cfg = dict(payload["cfg"])
    if "selfplay" in cfg:
        cfg["selfplay"] = SelfPlayConfig(**cfg["selfplay"])
    return EnvConfig(**payload.get("env", {})), cls(**cfg)


def host_tree(state) -> dict:
    """``{path: leaf}`` of a state on the host (a generator as its state)."""
    from pingpong_tpu_torch.checkpoint.full_state import flatten_tree

    out = {}
    for k, v in flatten_tree(state).items():
        if isinstance(v, torch.Generator):
            v = v.get_state()
        elif isinstance(v, torch.Tensor):
            v = v.detach().cpu().clone()
        out[k] = v
    return out


def build_learner(payload, mesh):
    from pingpong_tpu_torch.checkpoint.serialize import (
        qnet_from_numpy,
        qnet_rnn_from_numpy,
    )
    from pingpong_tpu_torch.train.dqn import DQNLearner
    from pingpong_tpu_torch.train.drqn import DRQNLearner

    env_cfg, cfg = _configs(payload)
    dqn = payload["kind"] == "dqn"
    cls = DQNLearner if dqn else DRQNLearner
    learner = cls(env_cfg, cfg, device=payload.get("device", "cpu"),
                  mesh=mesh)
    from_np = qnet_from_numpy if dqn else qnet_rnn_from_numpy
    params = (from_np(payload["params"]) if payload.get("params") is not None
              else None)
    return learner, params, from_np


def case_learner(payload):
    """``iters`` train iterations of a DQN or DRQN learner on this rank,
    from the whole state ``state_dir`` (a full-state directory) or a fresh
    one; every rank returns its replicated leaves, rank 0 the gathered
    whole state."""
    from pingpong_tpu_torch.checkpoint.full_state import restore_train_state
    from pingpong_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh()
    learner, params, from_np = build_learner(payload, mesh)
    glob = learner.init_global_state(payload.get("seed", 0), params,
                                     **payload.get("init", {}))
    if payload.get("state_dir"):
        glob = restore_train_state(payload["state_dir"], glob)
    state = learner.shard_state(glob)
    opp = learner.prepare_opponents([from_np(d) for d in payload["opp"]])
    metrics = []
    for it in range(payload["iters"]):
        kw = (payload.get("inject") or [{}] * payload["iters"])[it]
        state, m = learner.train_iteration(state, opp, payload["pool_size"],
                                           **kw)
        metrics.append(m._asdict())
    out = dict(metrics=metrics, sharded=learner.sharded,
               local=host_tree(state))
    whole = learner.gather_state(state)
    if mesh.rank == 0:
        out["global"] = host_tree(whole)
    return out


def case_loop(payload):
    """A self-play loop of ``kind`` on every rank (``mesh_cfg``): its
    records, the checkpoint writes of this rank, and with ``resume`` a
    kill-and-resume check: a second loop restores the autosave taken after
    ``block`` episodes and both train ``block`` more; the gathered states
    are returned."""
    from pingpong_tpu_torch.config.schema import MeshConfig
    from pingpong_tpu_torch.selfplay import generations, loop, loop_rnn
    from pingpong_tpu_torch.utils.metrics import MetricsLogger

    env_cfg, cfg = _configs(payload)
    dqn = payload["kind"] == "dqn"
    cls = loop.QNetSelfPlay if dqn else loop_rnn.DRQNSelfPlay
    writes = []
    real_save = generations.save_checkpoint

    def counting_save(path, payload_):
        writes.append(str(path))
        return real_save(path, payload_)

    generations.save_checkpoint = counting_save
    mk = lambda seed: cls(env_cfg, cfg, workdir=payload["workdir"],
                          seed=seed, logger=MetricsLogger(echo=False),
                          device="cpu", mesh_cfg=MeshConfig())
    out = {}
    if payload.get("resume"):
        block = payload["block"]
        d1 = mk(0)
        d1.current_generation, d1.done_generations = 2, 1
        d1._train_block(block)
        d1.autosave(wait=True)
        out["saved"] = host_tree(d1.learner.gather_state(d1.state))
        d2 = mk(7)
        out["resumed_mid"] = d2._resumed_mid_generation
        out["restored"] = host_tree(d2.learner.gather_state(d2.state))
        out["local_rows"] = d2.state.buffer.data.shape[0]
        d1._train_block(block)
        d2._train_block(block)
        out["straight"] = host_tree(d1.learner.gather_state(d1.state))
        out["continued"] = host_tree(d2.learner.gather_state(d2.state))
        d1.flush_autosave()
        d2.flush_autosave()
    else:
        d = mk(0)
        records = d.run()
        out["records"] = [dataclasses.asdict(r) for r in records]
        out["params"] = d.state.params.clone()
        out["mesh"] = d.learner.mesh is not None
        out["sharded"] = d.learner.sharded
    out["writes"] = writes
    return out


def case_collectives(payload):
    """The mesh helpers on this rank: ``replicate``, ``broadcast_values``,
    ``all_gather_cat`` and ``all_reduce_`` (SUM, MAX) over the data axis of
    a ``num_data x num_model`` mesh."""
    from pingpong_tpu_torch.config.schema import MeshConfig
    from pingpong_tpu_torch.parallel import mesh as m

    mesh = m.create_mesh(MeshConfig(num_model=payload["num_model"]))
    rank = torch.distributed.get_rank()
    x = torch.arange(3, dtype=torch.float32) + 10 * rank
    tree = {"a": x.clone(), "b": [torch.full((2,), float(rank))]}
    return dict(
        shape=mesh.shape, data_rank=mesh.rank,
        replicated=m.replicate(tree, mesh),
        values=m.broadcast_values([rank + 0.5, 7.0], mesh, "cpu"),
        gathered=m.all_gather_cat(x[None], mesh, dim=1),
        summed=m.all_reduce_(x.clone(), mesh),
        maxed=m.all_reduce_(x.clone() * (-1) ** rank, mesh, op="max"),
        block=m.shard_batch(torch.arange(12), mesh))


CASES = {"learner": case_learner, "loop": case_loop,
         "collectives": case_collectives}


def main(argv):
    case, rank, n, port, d = argv
    torch.set_num_threads(1)
    from pingpong_tpu_torch.parallel.mesh import initialize_distributed

    initialize_distributed(f"localhost:{port}", int(n), int(rank),
                           backend="gloo")
    payload = torch.load(Path(d) / "payload.pt", weights_only=False)
    out = CASES[case](payload)
    torch.save(out, Path(d) / f"result_{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
