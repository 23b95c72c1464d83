"""Phase split of the two update-block kernels, of the recurrent rollout
kernel and of the env-only rollout kernel on the card.

    python -m pingpong_tpu_torch.update_phases {drqn,dqn,rnn,pong}
        [--source FILE] [--reps N] [--envs B] [--slots N]
        [--updates K] [--batch BS] [--full-net] [--interval N]

Writes an instrumented copy of the kernel's source (default: the port's
own ``csrc/drqn_update.cu`` or ``csrc/dqn_update.cu``) under
``build/update_phases/``, builds it like the kernel and runs it through the
port's wrapper, with random weights and data from a seed:

- ``drqn`` (``configs/rnn.yaml``'s update block): every ``grid.sync();``
  becomes a stamp of the card's ``globaltimer`` by each block just before
  the barrier and just after it. For each barrier site it prints how long
  the slowest block computed before it (from the previous barrier's
  release to the last block's arrival) and how long the barrier held (from
  that arrival to the release). A site is named by a trailing ``// phase:
  NAME`` comment, or else by its line and the nearest ``// ----`` section
  header above it.
- ``dqn`` (``--updates`` K 64, ``--batch`` 256, replay 2^20, heads only
  unless ``--full-net``, target sync every ``--interval`` 1000 train steps
  from step 0): thread 0 of CTA 0 stamps after every line tagged ``//
  phase: NAME`` (the cluster barriers, the owner step and its push, and the
  top of the update loop); it prints the time from each tag to the next,
  summed by pair of tags. ``qnet.replay_heavy``'s block is ``--updates 256
  --full-net``; ``--interval 200`` puts one hard sync inside it.
- ``rnn`` (``configs/rnn.yaml``'s train chunk: ``--envs`` 1024 envs, 128
  steps, ``--slots`` 2 opponent slots in the learner's buckets): consumer
  thread 0 of block 0 stamps after every line tagged ``// phase: NAME``
  (the consumers' barriers; a net pass's tags count the opponent's and
  the learner's passes together), printed as for ``dqn``.
- ``pong`` (the headline bench's chunk: ``--envs`` 32768 envs, 1024 steps,
  tile 64): lane 0 of every warp stamps ``clock64()`` at the top of each
  iteration of the kernel's step loop (``for (int i = 0; i < steps; ++i)
  {``). The plain version runs the same chunk on the card and marks, for
  every env-step, a top paddle hit, a bottom paddle hit and a serve; a
  warp-step is marked when some env of the warp is (a warp runs 32
  consecutive envs, one a thread). It prints how many warp-steps carry
  each mark and the mean cycles of a warp-step by class: with no mark (the
  step), with a hit and no serve less the step (the collision), with a
  serve and no hit less the step (the serve). It also times the kernel as
  it is, writes its SASS to ``build/update_phases/pong.sass`` and prints
  the kernel's instruction count, its calls, divisions, special-function
  instructions and branches, and the compiler's register, stack and spill
  line.

Times are microseconds summed over one launch, averaged over ``--reps``
launches (and a call's share: for ``dqn``, per update), with the card's
name and power limit. The committed kernels are not changed; the copies
are not committed. ``--source`` takes another checkout's file, e.g. a
parent commit unpacked under ``build/parent/``.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
from collections import OrderedDict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "update_phases"
MAX_SYNC, MAX_BLK = 2048, 160

HEADER = f"""
#define PH_MAX_SYNC {MAX_SYNC}
#define PH_MAX_BLK {MAX_BLK}
__device__ unsigned long long ph_arr[PH_MAX_BLK * PH_MAX_SYNC];
__device__ unsigned long long ph_rel[PH_MAX_BLK * PH_MAX_SYNC];
__device__ int ph_site[PH_MAX_SYNC];
__device__ int ph_cnt[PH_MAX_BLK];
__device__ __forceinline__ unsigned long long ph_now() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
#define PHASE_SYNC(g, site) do {{                                        \\
  __syncthreads();                                                       \\
  if (threadIdx.x == 0) {{                                                \\
    const int n_ = ph_cnt[blockIdx.x];                                    \\
    if (n_ < PH_MAX_SYNC) {{                                              \\
      ph_arr[blockIdx.x * PH_MAX_SYNC + n_] = ph_now();                  \\
      if (blockIdx.x == 0) ph_site[n_] = site;                           \\
    }}                                                                    \\
  }}                                                                      \\
  g.sync();                                                              \\
  if (threadIdx.x == 0) {{                                                \\
    const int n_ = ph_cnt[blockIdx.x];                                    \\
    if (n_ < PH_MAX_SYNC) ph_rel[blockIdx.x * PH_MAX_SYNC + n_] = ph_now(); \\
    ph_cnt[blockIdx.x] = n_ + 1;                                          \\
  }}                                                                      \\
}} while (0)
#line 1
"""

FOOTER = """
extern "C" int ph_reset() {
  static int zeros[PH_MAX_BLK] = {0};
  return (int)cudaMemcpyToSymbol(ph_cnt, zeros, sizeof(zeros));
}
extern "C" int ph_read(unsigned long long* arr, unsigned long long* rel,
                       int* site, int* cnt) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(arr, ph_arr, sizeof(ph_arr));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(rel, ph_rel, sizeof(ph_rel));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(site, ph_site, sizeof(ph_site));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(cnt, ph_cnt, sizeof(ph_cnt));
  return (int)e;
}
"""


def instrument_drqn(src: str):
    """The instrumented DRQN source and each barrier site's name by line."""
    lines = src.splitlines()
    names, section = {}, "start"
    out = []
    for no, line in enumerate(lines, start=1):
        m = re.search(r"//\s*----\s*(.*?)\s*-*\s*$", line)
        if m:
            section = m.group(1)
        if "grid.sync();" in line:
            tag = re.search(r"//\s*phase:\s*(.+?)\s*$", line)
            names[no] = tag.group(1) if tag else f"line {no}: {section}"
            line = line.replace("grid.sync();", f"PHASE_SYNC(grid, {no});")
        out.append(line)
    return HEADER + "\n".join(out) + "\n" + FOOTER, names


DQN_HEADER = """
__device__ unsigned long long st_t[8192];
__device__ int st_id[8192];
__device__ int st_n;
#define STAMP(site) do {                                                   \\
  if (threadIdx.x == 0 && cg::this_cluster().block_rank() == 0 &&          \\
      st_n < 8192) {                                                       \\
    unsigned long long t_;                                                 \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                 \\
    st_t[st_n] = t_; st_id[st_n] = site; ++st_n;                           \\
  }                                                                        \\
} while (0)
"""

DQN_FOOTER = """
extern "C" int st_read(unsigned long long* t, int* id, int* n) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(t, st_t, sizeof(st_t));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(id, st_id, sizeof(st_id));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(n, st_n, sizeof(int));
  const int zero = 0;
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(st_n, &zero, sizeof(int));
  return (int)e;
}
"""


RNN_HEADER = DQN_HEADER.replace(
    "cg::this_cluster().block_rank() == 0", "blockIdx.x == 0")


def instrument_dqn(src: str, anchor="namespace cg = cooperative_groups;\n",
                   header=DQN_HEADER):
    """The instrumented source (a stamp after each ``// phase:`` line)
    and each site's name by id."""
    names, out = {}, []
    for line in src.splitlines():
        out.append(line)
        tag = re.search(r"//\s*phase:\s*(.+?)\s*$", line)
        if tag:
            names[len(names)] = tag.group(1)
            out.append(f"STAMP({len(names) - 1});")
    text = "\n".join(out)
    return (text.replace(anchor, anchor + header, 1) + "\n" + DQN_FOOTER,
            names)


def instrument_rnn(src: str):
    return instrument_dqn(src, '#include "pong_env.cuh"\n', RNN_HEADER)


PONG_LOOP = "for (int i = 0; i < steps; ++i) {"
PONG_HEADER = """
__device__ unsigned long long* ph_clk;
__device__ int ph_steps;
#define PH_STAMP(i) do {                                                   \\
  const unsigned long long c_ = clock64();                                 \\
  if ((threadIdx.x & 31) == 0)                                             \\
    ph_clk[(size_t)((blockIdx.x * blockDim.x + threadIdx.x) >> 5) *        \\
           ph_steps + (i)] = c_;                                           \\
} while (0)
"""
PONG_FOOTER = """
extern "C" int ph_set(unsigned long long* clk, int steps) {
  cudaError_t e = cudaMemcpyToSymbol(ph_clk, &clk, sizeof(clk));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(ph_steps, &steps, sizeof(int));
  return (int)e;
}
"""


def instrument_pong(src: str):
    """The kernel's source with a ``clock64()`` stamp at the top of every
    step of its step loop."""
    if src.count(PONG_LOOP) != 1:
        raise ValueError(f"the kernel needs one step loop '{PONG_LOOP}'")
    anchor = '#include "pong_env.cuh"\n'
    text = src.replace(anchor, anchor + PONG_HEADER, 1)
    return text.replace(PONG_LOOP, PONG_LOOP + " PH_STAMP(i);", 1) + \
        PONG_FOOTER, {}


def build(source: Path, kernel: str) -> tuple:
    OUT.mkdir(parents=True, exist_ok=True)
    instrument = {"drqn": instrument_drqn, "dqn": instrument_dqn,
                  "rnn": instrument_rnn, "pong": instrument_pong}[kernel]
    text, names = instrument(source.read_text())
    cu = OUT / f"{kernel}_phases.cu"
    cu.write_text(text)
    lib = OUT / f"lib{kernel}_phases.so"
    nvcc(cu, lib, source.parent)
    return lib, names


def nvcc(cu: Path, lib: Path, include: Path) -> str:
    """Build ``cu`` into ``lib`` as the port builds its kernels; returns
    the compiler's log."""
    from pingpong_tpu_torch.ops.build import NVCC_FLAGS, nvcc_path

    res = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-I", str(include),
                          "-o", str(lib), str(cu)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    return res.stdout + res.stderr


def inputs_drqn(dev, seed=600):
    """``configs/rnn.yaml``'s update block (K, bs, T and widths) with
    random weights and traces from ``seed``: no sync in the block, so the
    k = 0 wide target pass runs once."""
    from pingpong_tpu_torch.config import load_config
    from pingpong_tpu_torch.models.qnet_rnn import (
        qnet_rnn_init,
        qnet_rnn_sample_noise,
        qnet_rnn_to_flat,
    )
    from pingpong_tpu_torch.ops.drqn_update import flat_noise, kernel_inputs

    c = load_config(ROOT / "configs" / "rnn.yaml").drqn
    K, bs, T = c.updates_per_iteration, c.batch_size, c.trace_length
    gen = torch.Generator().manual_seed(seed)
    net, tgt = (qnet_rnn_init(gen, feature_dim=c.feature_dim,
                              lstm_hidden_dim=c.lstm_hidden_dim,
                              head_hidden_dim=c.head_hidden_dim).to(dev)
                for _ in range(2))
    g = torch.Generator(dev).manual_seed(seed)
    obs = torch.rand((K, bs, T + 1, 7), generator=g, device=dev)
    xt, nextt, meta = kernel_inputs(
        obs[:, :, :T].contiguous(), obs[:, :, 1:].contiguous(),
        torch.randint(0, 3, (K, bs), generator=g, device=dev),
        torch.randn((K, bs), generator=g, device=dev),
        torch.rand((K, bs), generator=g, device=dev) < 0.2,
        torch.rand((K, bs), generator=g, device=dev) < 0.9)
    params = qnet_rnn_to_flat(net)
    return dict(ts0=0, count0=0, xt=xt, nextt=nextt, meta=meta,
                noise=flat_noise(qnet_rnn_sample_noise(gen, net, batch=(K,)))
                .to(dev), params=params, target=qnet_rnn_to_flat(tgt),
                m=torch.zeros_like(params), v=torch.zeros_like(params),
                dims=(c.feature_dim // 2, c.feature_dim, c.lstm_hidden_dim,
                      c.head_hidden_dim), K=K, bs=bs, T=T, lr=c.lr,
                clip=c.grad_clip_norm, gamma=c.gamma,
                interval=c.target_update_interval, tau=0.0)


def inputs_dqn(dev, seed=7, bs=256, K=64, cap=1 << 20, heads_only=True,
               interval=1000):
    """K updates of ``bs`` from a full replay of ``cap`` random transitions
    with random priorities, from train step 0: a hard target sync after
    every ``interval`` updates (none in the block at the defaults)."""
    from pingpong_tpu_torch.models.qnet import (
        qnet_init,
        qnet_sample_noise,
        qnet_to_flat,
    )
    from pingpong_tpu_torch.ops.dqn_update import pack_dqn_noise
    from pingpong_tpu_torch.replay.per import Transition, per_init, per_push

    g = torch.Generator(device=dev).manual_seed(seed)
    buf = per_init(cap, device=dev, block=True)
    m = min(262144, cap)
    for _ in range(cap // m):
        per_push(buf, Transition(
            obs=torch.rand((m, 7), generator=g, device=dev) * 2 - 1,
            action=torch.randint(0, 3, (m,), generator=g, device=dev,
                                 dtype=torch.int32),
            reward=torch.randn((m,), generator=g, device=dev),
            next_obs=torch.rand((m, 7), generator=g, device=dev) * 2 - 1,
            done=torch.rand((m,), generator=g, device=dev) < 0.2), 0.6)
    buf.p_alpha.copy_((0.1 + 1.9 * torch.rand(cap, generator=g, device=dev))
                      ** 0.6)
    buf.chunk_sums.copy_(buf.p_alpha.view(-1, 128).sum(dim=1))
    hg = torch.Generator().manual_seed(seed)
    params = qnet_to_flat(qnet_init(hg)).to(dev)
    return dict(ts0=0, count0=0, frame0=0, size=buf.size,
                u01=torch.rand((K, bs), generator=g, device=dev),
                noise=pack_dqn_noise(qnet_sample_noise(
                    hg, qnet_init(hg), batch=(K,))).to(dev),
                p_alpha=buf.p_alpha, chunk_sums=buf.chunk_sums,
                params=params, target=qnet_to_flat(qnet_init(hg)).to(dev),
                m=torch.zeros_like(params), v=torch.zeros_like(params),
                data=buf.data, K=K, bs=bs, lr=2.5e-4, gamma=0.99,
                interval=interval, tau=0.0, alpha=0.6, per_eps=1e-6,
                beta_start=0.4, beta_frames=100_000, heads_only=heads_only)


def inputs_rnn(dev, B=1024, n_slots=2, seed=500):
    """``configs/rnn.yaml``'s train chunk with random nets from ``seed``:
    ``(args, kw)`` of ``recurrent_rollout_cuda``, ``n_slots`` opponents in
    the learner's buckets."""
    from pingpong_tpu_torch.config import load_config
    from pingpong_tpu_torch.env.pong import env_params_from_config, reset
    from pingpong_tpu_torch.models.qnet_rnn import qnet_rnn_init
    from pingpong_tpu_torch.ops import recurrent_rollout as rr
    from pingpong_tpu_torch.train.dqn import bucket_opp_idx

    cfg = load_config(ROOT / "configs" / "rnn.yaml")
    c = cfg.drqn
    gen = torch.Generator().manual_seed(seed)
    learner, *members = (qnet_rnn_init(
        gen, feature_dim=c.feature_dim, lstm_hidden_dim=c.lstm_hidden_dim,
        head_hidden_dim=c.head_hidden_dim).to(dev) for _ in range(1 + n_slots))
    env = env_params_from_config(cfg.env)
    hid = torch.rand((4 * c.lstm_hidden_dim, B), generator=torch.Generator(
        dev).manual_seed(seed), device=dev) - 0.5
    args = (env, reset(env, B, gen, dev), bucket_opp_idx(
        B, c.selfplay.opponent_pool_ratio, n_slots - 1, device=dev),
        torch.zeros(B, device=dev), hid, rr.pack_qnet_rnn(learner),
        rr.pack_rnn_sigma(learner), rr.pack_qnet_rnn(members, mirror=True))
    kw = dict(seed=11, eps_i=300000, steps=c.rollout_length,
              max_episode_steps=c.max_episode_steps,
              tile_rows=min(c.pallas_tile_rows, B), emit_transitions=True)
    return args, kw


def split_rnn(lib, names, args, kw, reps):
    """As :func:`split_dqn`, for the recurrent rollout kernel."""
    import numpy as np

    from pingpong_tpu_torch.ops import recurrent_rollout as rr

    saved, rr.KERNEL = rr.KERNEL, kernel_from(
        lib, rr.KERNEL.argtypes, "recurrent_rollout",
        "recurrent_rollout_launch")
    cdll = ctypes.CDLL(str(lib))
    t = np.zeros(8192, np.uint64)
    ids = np.zeros(8192, np.int32)
    n = np.zeros(1, np.int32)
    ptrs = [x.ctypes.data_as(ctypes.c_void_p) for x in (t, ids, n)]
    acc, ev_ms = OrderedDict(), []
    run = lambda: rr.recurrent_rollout_cuda(*args, **kw)
    try:
        run()                                     # warm
        torch.cuda.synchronize()
        assert cdll.st_read(*ptrs) == 0
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            torch.cuda.synchronize()
            ev_ms.append(a.elapsed_time(b))
            assert cdll.st_read(*ptrs) == 0
            for i in range(1, int(n[0])):
                key = f"{names[int(ids[i - 1])]} -> {names[int(ids[i])]}"
                c, us = acc.get(key, (0, 0.0))
                acc[key] = (c + 1, us + (int(t[i]) - int(t[i - 1])) / 1e3)
    finally:
        rr.KERNEL = saved
    return ({key: (c / reps, us / reps, 0.0) for key, (c, us) in acc.items()},
            ev_ms, 1)


def fresh(kw):
    return {a: (b.clone() if isinstance(b, torch.Tensor) else b)
            for a, b in kw.items()}


def timed(fn, kw):
    """One launch on fresh inputs; its event time in ms."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn(**fresh(kw))
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def split_dqn(lib, names, kw, reps):
    """Per pair of tags: microseconds summed over one launch, averaged
    over ``reps`` launches; and the launches' event times."""
    import numpy as np

    from pingpong_tpu_torch.ops import dqn_update as du

    saved, du.KERNEL = du.KERNEL, kernel_from(lib, du.KERNEL.argtypes,
                                              "dqn_update", "dqn_update_launch")
    cdll = ctypes.CDLL(str(lib))
    t = np.zeros(8192, np.uint64)
    ids = np.zeros(8192, np.int32)
    n = np.zeros(1, np.int32)
    ptrs = [x.ctypes.data_as(ctypes.c_void_p) for x in (t, ids, n)]
    acc, ev_ms = OrderedDict(), []
    try:
        timed(du.dqn_update_cuda, kw)            # warm
        assert cdll.st_read(*ptrs) == 0
        for _ in range(reps):
            ev_ms.append(timed(du.dqn_update_cuda, kw))
            assert cdll.st_read(*ptrs) == 0
            for a in range(1, int(n[0])):
                key = f"{names[int(ids[a - 1])]} -> {names[int(ids[a])]}"
                c, us = acc.get(key, (0, 0.0))
                acc[key] = (c + 1, us + (int(t[a]) - int(t[a - 1])) / 1e3)
    finally:
        du.KERNEL = saved
    return ({key: (c / reps, us / reps, 0.0) for key, (c, us) in acc.items()},
            ev_ms, 8)


def kernel_from(lib, argtypes, name, symbol):
    from pingpong_tpu_torch.ops.build import CudaKernel

    k = CudaKernel(name, symbol, argtypes)
    k.library = lib
    k._stale = lambda: False
    return k


def split(lib, names, kw, reps):
    """Per site: (calls, compute us, barrier us) summed over one launch,
    averaged over ``reps`` launches; and the launches' event times."""
    import numpy as np

    from pingpong_tpu_torch.ops import drqn_update as dru

    saved, dru.KERNEL = dru.KERNEL, kernel_from(
        lib, dru.KERNEL.argtypes, "drqn_update", "drqn_update_launch")
    cdll = ctypes.CDLL(str(lib))
    arr = np.zeros(MAX_BLK * MAX_SYNC, np.uint64)
    rel = np.zeros_like(arr)
    site = np.zeros(MAX_SYNC, np.int32)
    cnt = np.zeros(MAX_BLK, np.int32)
    acc = OrderedDict()
    ev_ms = []
    try:
        timed(dru.drqn_update_cuda, kw)          # warm
        for _ in range(reps):
            assert cdll.ph_reset() == 0
            ev_ms.append(timed(dru.drqn_update_cuda, kw))
            assert cdll.ph_read(*(x.ctypes.data_as(ctypes.c_void_p)
                                  for x in (arr, rel, site, cnt))) == 0
            nb = int((cnt > 0).sum())
            n = int(cnt[0])
            A = arr.reshape(MAX_BLK, MAX_SYNC)[:nb, :n].astype(np.float64)
            R = rel.reshape(MAX_BLK, MAX_SYNC)[:nb, :n].astype(np.float64)
            last_arr, first_rel = A.max(axis=0), R.min(axis=0)
            start = np.concatenate([[A[:, 0].min()], first_rel[:-1]])
            for i in range(n):
                key = names.get(int(site[i]), f"line {int(site[i])}")
                c, comp, bar = acc.get(key, (0, 0.0, 0.0))
                acc[key] = (c + 1, comp + (last_arr[i] - start[i]) / 1e3,
                            bar + (first_rel[i] - last_arr[i]) / 1e3)
    finally:
        dru.KERNEL = saved
    return ({key: (c / reps, comp / reps, bar / reps)
             for key, (c, comp, bar) in acc.items()}, ev_ms, nb)


def pong_marks(params, state, steps, seed, tile_rows):
    """The plain chunk's marks by warp-step: ``(top, bottom, serve)``, each
    ``(steps, warps)`` bool, a warp (32 consecutive envs) marked when some
    env of it is."""
    import numpy as np

    from pingpong_tpu_torch.ops import pong_kernel as pk

    B, dev = state.ball_x.shape[0], state.ball_x.device
    cells = pk.hash_cells(B, seed, tile_rows, dev)
    tol = float(np.float32(0.02))
    marks = torch.zeros((3, steps, B // 32), dtype=torch.bool, device=dev)
    for i in range(steps):
        state, _, done, hit = pk.plain_step(params, state, i, cells, tol)
        for m, x in enumerate((hit & (state.ball_y == 0.0),
                               hit & (state.ball_y == 1.0), done)):
            marks[m, i] = x.view(-1, 32).any(dim=1)
    return marks


def sass_summary(lib: Path, log: str):
    """The kernel's SASS into ``OUT/pong.sass``; its instruction count,
    calls, branches, division checks and special-function instructions,
    and the compiler's lines for it."""
    import shutil
    from collections import Counter

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    (OUT / "pong.sass").write_text(sass)
    body = sass.split("Function : ")
    body = next((b for b in body if "pong_rollout_kernel" in
                 b.splitlines()[0]), "")
    ops = Counter(m.group(1) for m in re.finditer(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", body))
    keys = ("CALL", "BRA", "BSSY", "FCHK", "MUFU", "I2F", "F2I", "IMAD",
            "FFMA", "FMUL", "FADD", "STL", "LDL")
    info = [ln.strip() for ln in log.splitlines()
            if "pong_rollout" in ln or "registers" in ln or "stack" in ln]
    return sum(ops.values()), {k: v for k, v in sorted(ops.items())
                               if k.split(".")[0] in keys}, info


def split_pong(source: Path, B: int, reps: int):
    """Build the kernel at ``source`` as it is and instrumented, run both
    on the bench's chunk; returns the report's lines."""
    import ctypes as ct

    from pingpong_tpu_torch.bench import rollout_env_cfg
    from pingpong_tpu_torch.env.pong import env_params_from_config, reset
    from pingpong_tpu_torch.ops import pong_kernel as pk

    dev, steps, tile = torch.device("cuda"), 1024, 64
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "libpong_kernel.so"
    log = nvcc(source, lib, source.parent)
    inst_lib, _ = build(source, "pong")
    params = env_params_from_config(rollout_env_cfg())
    state = reset(params, B, torch.Generator().manual_seed(700), dev)
    run = lambda: pk.pong_rollout_cuda(params, state, steps, 5,
                                       tile_rows=tile)
    n_warps = B // 32
    clk = torch.zeros((n_warps, steps), dtype=torch.int64, device=dev)
    lines, saved = [], pk.KERNEL
    try:
        times = {}
        for name, path in (("as built", lib), ("instrumented", inst_lib)):
            pk.KERNEL = kernel_from(path, saved.argtypes, "pong_kernel",
                                    "pong_rollout_launch")
            if path == inst_lib:
                set_ = ct.CDLL(str(path)).ph_set
                set_.argtypes = [ct.c_void_p, ct.c_int]
                assert set_(clk.data_ptr(), steps) == 0
            for _ in range(10):                  # warm, clocks up
                run()
            torch.cuda.synchronize()
            ms = []
            for _ in range(reps):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                run()
                b.record()
                torch.cuda.synchronize()
                ms.append(a.elapsed_time(b))
            times[name] = ms
    finally:
        pk.KERNEL = saved
    top, bot, serve = pong_marks(params, state, steps, 5, tile)
    d = (clk[:, 1:] - clk[:, :-1]).T.double()       # (steps - 1, warps)
    top, bot, serve = top[:-1], bot[:-1], serve[:-1]
    hit = top | bot
    n = d.numel()
    classes = OrderedDict([
        ("no hit, no serve (the step)", ~hit & ~serve),
        ("top hit only", top & ~bot & ~serve),
        ("bottom hit only", bot & ~top & ~serve),
        ("both hits", top & bot & ~serve),
        ("serve, no hit", serve & ~hit),
        ("hit and serve", hit & serve)])
    base = float(d[classes["no hit, no serve (the step)"]].mean())
    lines.append(f"{source}: B {B}, {steps} steps, tile {tile}; {n_warps} "
                 f"warps; launch (events) as built "
                 f"{', '.join(f'{x:.4f}' for x in times['as built'])} "
                 f"ms, instrumented "
                 f"{', '.join(f'{x:.4f}' for x in times['instrumented'])} ms")
    lines.append(f"warp-steps {n}: some lane hits the top paddle "
                 f"{int(top.sum())} ({float(top.double().mean()):.4f}), the "
                 f"bottom {int(bot.sum())} ({float(bot.double().mean()):.4f}),"
                 f" both {int((top & bot).sum())} "
                 f"({float((top & bot).double().mean()):.4f}), either "
                 f"{int(hit.sum())} ({float(hit.double().mean()):.4f}); some "
                 f"lane serves {int(serve.sum())} "
                 f"({float(serve.double().mean()):.4f})")
    lines.append(f"cycles a warp-step: mean {float(d.mean()):.1f} over all")
    for name, mask in classes.items():
        k = int(mask.sum())
        mean = float(d[mask].mean()) if k else float("nan")
        lines.append(f"  {name:28s} {k:9d} warp-steps, mean {mean:8.1f}, "
                     f"less the step {mean - base:8.1f}")
    lines.append(f"split of the mean warp-step: step {base:.1f}, collision "
                 f"{float((d - base)[hit & ~serve].sum()) / n:.1f}, serve "
                 f"{float((d - base)[serve].sum()) / n:.1f} cycles")
    total, ops, info = sass_summary(lib, log)
    lines.append(f"SASS ({OUT / 'pong.sass'}): {total} instructions in "
                 f"pong_rollout_kernel; {ops}")
    lines += [f"ptxas: {ln}" for ln in info]
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=("drqn", "dqn", "rnn", "pong"))
    ap.add_argument("--source", type=Path)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--envs", type=int)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--updates", type=int, default=64)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--full-net", action="store_true")
    ap.add_argument("--interval", type=int, default=1000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("update_phases: no CUDA device")
        return 1
    dev = torch.device("cuda")
    source = args.source or (ROOT / "pingpong_tpu_torch" / "csrc" / {
        "rnn": "recurrent_rollout.cu", "pong": "pong_kernel.cu"}.get(
            args.kernel, f"{args.kernel}_update.cu"))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    if args.kernel == "pong":
        for line in split_pong(source, args.envs or 32768, args.reps):
            print(f"[phases:pong] {line} | {card}")
        return 0
    lib, names = build(source, args.kernel)
    if args.kernel == "rnn":
        envs = args.envs or 1024
        rargs, rkw = inputs_rnn(dev, envs, args.slots)
        table, ev_ms, nb = split_rnn(lib, names, rargs, rkw, args.reps)
        shape = (f"B {envs}, T {rkw['steps']}, {args.slots} slots, "
                 f"block 0")
    elif args.kernel == "drqn":
        kw = inputs_drqn(dev)
        table, ev_ms, nb = split(lib, names, kw, args.reps)
        shape = f"K {kw['K']}, bs {kw['bs']}, T {kw['T']}, dims {kw['dims']}"
    else:
        kw = inputs_dqn(dev, bs=args.batch, K=args.updates,
                        heads_only=not args.full_net, interval=args.interval)
        table, ev_ms, nb = split_dqn(lib, names, kw, args.reps)
        shape = (f"K {kw['K']}, bs {kw['bs']}, replay 2^20, "
                 f"{'full net' if args.full_net else 'heads only'}, "
                 f"interval {args.interval}")
    tot_c = sum(v[1] for v in table.values())
    tot_b = sum(v[2] for v in table.values())
    tag = f"[phases:{args.kernel}]"
    print(f"{tag} {source}: {shape}, {nb} blocks; launch (events, "
          f"instrumented) {', '.join(f'{x:.3f}' for x in ev_ms)} ms | {card}")
    print(f"{tag} {'site':60s} {'calls':>6s} {'compute us':>11s} "
          f"{'barrier us':>11s} {'us a call':>10s}")
    for key, (c, comp, bar) in table.items():
        print(f"{tag} {key[:60]:60s} {c:6.0f} {comp:11.1f} {bar:11.1f} "
              f"{(comp + bar) / c:10.3f}")
    print(f"{tag} {'total':60s} {'':6s} {tot_c:11.1f} {tot_b:11.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
