"""ctypes bindings and on-demand build of the native C++ Pong engine (port
of ``pingpong_tpu/native/engine.py``).

The shared library is compiled with ``g++`` from the port's own copy of
the engine, ``pingpong_tpu_torch/csrc/pong_engine.cpp``, at first use,
into ``build/torch_native/libpong_engine.so`` of the checkout. The build
is atomic: the compiler writes a name of its own in that directory and
the finished library is ``os.replace``d into place, so two processes that
build at once never ``dlopen`` a half-written file. The engine is not a
CUDA kernel; ``ops/build.py`` never picks it up.

Uses:
* differential testing: an independent compiled implementation of the env
  semantics, fast enough to sweep many steps against the port's env
  (``tests/test_torch_native_engine.py``, ``chip_smoke.py [view:engine]``);
* the host-side env engine of the live viewer (``viewer/live.py``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

import numpy as np

from pingpong_tpu_torch.config.schema import EnvConfig

SRC = Path(__file__).resolve().parent.parent / "csrc" / "pong_engine.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
LIB = BUILD_DIR / "libpong_engine.so"
CXX_FLAGS = [
    "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
    # strict IEEE mul/add pairing: FMA contraction would drift from the
    # unfused float32 tensor ops and fail the differential harness
    "-ffp-contract=off",
]

_F = ctypes.POINTER(ctypes.c_float)
_I = ctypes.POINTER(ctypes.c_int32)
_U8 = ctypes.POINTER(ctypes.c_uint8)


class _PongParams(ctypes.Structure):
    _fields_ = [
        ("paddle_width", ctypes.c_float),
        ("paddle_speed", ctypes.c_float),
        ("max_score", ctypes.c_int32),
        ("enable_spin", ctypes.c_float),
        ("magnus_factor", ctypes.c_float),
        ("restitution", ctypes.c_float),
        ("friction", ctypes.c_float),
        ("ball_mass", ctypes.c_float),
        ("ball_radius", ctypes.c_float),
    ]


class _PongStateSoA(ctypes.Structure):
    _fields_ = [
        ("ball_x", _F), ("ball_y", _F), ("ball_vx", _F), ("ball_vy", _F),
        ("spin", _F), ("top_x", _F), ("bottom_x", _F),
        ("score_a", _I), ("score_b", _I), ("bounce", _I), ("t", _I),
    ]


class _PongScaleCfg(ctypes.Structure):
    _fields_ = [
        ("speed_scale_every", ctypes.c_int32),
        ("speed_increment", ctypes.c_float),
    ]


def build_engine(force: bool = False) -> Path:
    """Compile the shared library unless one newer than its source
    exists; returns its path."""
    if (not force and LIB.exists()
            and LIB.stat().st_mtime >= SRC.stat().st_mtime):
        return LIB
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libpong_engine.so.tmp-{os.getpid()}"
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, LIB)
    finally:
        tmp.unlink(missing_ok=True)
    return LIB


def engine_available() -> bool:
    """The engine builds here (``g++`` present and working)."""
    try:
        build_engine()
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


@dataclass
class SoAState:
    """numpy structure-of-arrays env state (mutated in place)."""

    ball_x: np.ndarray
    ball_y: np.ndarray
    ball_vx: np.ndarray
    ball_vy: np.ndarray
    spin: np.ndarray
    top_x: np.ndarray
    bottom_x: np.ndarray
    score_a: np.ndarray
    score_b: np.ndarray
    bounce: np.ndarray
    t: np.ndarray

    @classmethod
    def zeros(cls, n: int) -> "SoAState":
        f = lambda: np.zeros(n, np.float32)
        i = lambda: np.zeros(n, np.int32)
        return cls(f(), f(), f(), f(), f(), f(), f(), i(), i(), i(), i())


class NativeEngine:
    def __init__(self, cfg: EnvConfig):
        lib = ctypes.CDLL(str(build_engine()))
        lib.pong_engine_abi_version.argtypes = []
        lib.pong_engine_abi_version.restype = ctypes.c_int32
        if lib.pong_engine_abi_version() != 1:
            raise RuntimeError(f"{LIB}: unexpected engine ABI version")
        params = ctypes.POINTER(_PongParams)
        scale = ctypes.POINTER(_PongScaleCfg)
        soa = ctypes.POINTER(_PongStateSoA)
        lib.pong_step_batch.argtypes = [params, scale, soa, _I, _I,
                                        ctypes.c_int64, _F, _U8]
        lib.pong_step_batch.restype = None
        lib.pong_rollout_bot.argtypes = [params, scale, soa, ctypes.c_int64,
                                         ctypes.c_int32, ctypes.c_float, _F,
                                         _U8]
        lib.pong_rollout_bot.restype = ctypes.c_int64
        self.lib = lib
        self.params = _PongParams(
            paddle_width=cfg.paddle_width,
            paddle_speed=cfg.paddle_speed,
            max_score=cfg.max_score,
            enable_spin=1.0 if cfg.enable_spin else 0.0,
            magnus_factor=cfg.magnus_factor,
            restitution=cfg.restitution,
            friction=cfg.friction,
            ball_mass=cfg.ball_mass,
            ball_radius=cfg.world_ball_radius,
        )
        self.scale = _PongScaleCfg(
            speed_scale_every=cfg.speed_scale_every,
            speed_increment=cfg.speed_increment,
        )

    @staticmethod
    def _soa(s: SoAState) -> _PongStateSoA:
        """Pointers into ``s``'s arrays, after checking each is a
        contiguous float32 or int32 array of one length."""
        n = len(s.ball_x)
        for name, dtype in (("ball_x", np.float32), ("ball_y", np.float32),
                            ("ball_vx", np.float32), ("ball_vy", np.float32),
                            ("spin", np.float32), ("top_x", np.float32),
                            ("bottom_x", np.float32), ("score_a", np.int32),
                            ("score_b", np.int32), ("bounce", np.int32),
                            ("t", np.int32)):
            a = getattr(s, name)
            if (a.dtype != dtype or a.shape != (n,)
                    or not a.flags.c_contiguous or not a.flags.writeable):
                raise ValueError(f"SoAState.{name} must be a writeable "
                                 f"contiguous {np.dtype(dtype)} array of "
                                 f"length {n}")
        fp = lambda a: a.ctypes.data_as(_F)
        ip = lambda a: a.ctypes.data_as(_I)
        return _PongStateSoA(
            fp(s.ball_x), fp(s.ball_y), fp(s.ball_vx), fp(s.ball_vy),
            fp(s.spin), fp(s.top_x), fp(s.bottom_x),
            ip(s.score_a), ip(s.score_b), ip(s.bounce), ip(s.t),
        )

    def step(
        self, state: SoAState, actions_a: np.ndarray, actions_b: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """In-place batched step; returns (reward_b, done)."""
        n = len(state.ball_x)
        aa = np.ascontiguousarray(actions_a, np.int32)
        ab = np.ascontiguousarray(actions_b, np.int32)
        if aa.shape != (n,) or ab.shape != (n,):
            raise ValueError(f"actions must have shape ({n},)")
        reward = np.zeros(n, np.float32)
        done = np.zeros(n, np.uint8)
        soa = self._soa(state)
        self.lib.pong_step_batch(
            ctypes.byref(self.params), ctypes.byref(self.scale),
            ctypes.byref(soa), aa.ctypes.data_as(_I), ab.ctypes.data_as(_I),
            n, reward.ctypes.data_as(_F), done.ctypes.data_as(_U8),
        )
        return reward, done.astype(bool)

    def rollout_bot(
        self, state: SoAState, steps: int, tolerance: float = 0.02
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Bot-vs-bot rollout until done or ``steps``; returns
        (reward_acc, done_flags)."""
        n = len(state.ball_x)
        reward = np.zeros(n, np.float32)
        done = np.zeros(n, np.uint8)
        soa = self._soa(state)
        self.lib.pong_rollout_bot(
            ctypes.byref(self.params), ctypes.byref(self.scale),
            ctypes.byref(soa), n, steps, tolerance,
            reward.ctypes.data_as(_F), done.ctypes.data_as(_U8),
        )
        return reward, done.astype(bool)
