// Native batched Pong engine (the port's copy of the JAX package's
// csrc/pong_engine.cpp; the code is the same).
//
// C++ implementation of the same physics/step semantics as
// pingpong_tpu_torch/env/pong.py and the JAX package's env/pong.py (both
// re-expressions of the reference's envs/{physics.py,my_pong_env_2p.py}).
// Two jobs:
//
//  1. differential-testing oracle: float32 math in the exact operation
//     order of the tensor step, so the port's trajectories (CPU or card)
//     can be checked against an independent compiled implementation over
//     millions of steps per second;
//  2. host-side engine for the live viewer and tooling, with no
//     accelerator involved.
//
// Exposed as a plain C ABI consumed via ctypes. It is not a CUDA kernel:
// it is built with g++ by pingpong_tpu_torch/native/engine.py, never by
// ops/build.py. Batched layout: structure-of-arrays, one entry per env.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

struct PongParams {
  float paddle_width;
  float paddle_speed;
  int32_t max_score;
  float enable_spin;  // 0.0 / 1.0
  float magnus_factor;
  float restitution;
  float friction;
  float ball_mass;
  float ball_radius;
};

struct PongStateSoA {
  float* ball_x;
  float* ball_y;
  float* ball_vx;
  float* ball_vy;
  float* spin;
  float* top_x;
  float* bottom_x;
  int32_t* score_a;
  int32_t* score_b;
  int32_t* bounce;
  int32_t* t;
};

struct PongScaleCfg {
  int32_t speed_scale_every;
  float speed_increment;
};

static inline float paddle_vel(int32_t action, float speed) {
  return (static_cast<float>(action) - 1.0f) * speed;
}

// Rigid sphere vs moving plane; float32 in the jnp kernel's op order.
static inline void collide(float vn, float vt, float u, float omega,
                           const PongParams& p, float* vn_post,
                           float* vt_post, float* omega_post) {
  *vn_post = -p.restitution * vn;
  float Jn = p.ball_mass * (1.0f + p.restitution) * std::fabs(vn);
  float I = 0.4f * p.ball_mass * p.ball_radius * p.ball_radius;
  float Jt_star =
      (2.0f * p.ball_mass / 7.0f) * (u + p.ball_radius * omega - vt);
  float cap = p.friction * Jn;
  float vrel = (vt - u) - p.ball_radius * omega;
  float sign_vrel = vrel >= 0.0f ? 1.0f : -1.0f;
  float Jt = std::fabs(Jt_star) <= cap ? Jt_star : -cap * sign_vrel;
  *vt_post = vt + Jt / p.ball_mass;
  *omega_post = omega - (p.ball_radius * Jt) / I;
}

// One masked step for n envs. actions_*: int32[n] in {0,1,2}.
// reward_b/done_out: per-env outputs (reward_a == -reward_b).
void pong_step_batch(const PongParams* params, const PongScaleCfg* scale_cfg,
                     PongStateSoA* s, const int32_t* actions_a,
                     const int32_t* actions_b, int64_t n, float* reward_b,
                     uint8_t* done_out) {
  const PongParams p = *params;
  const float half_w = p.paddle_width * 0.5f;
  for (int64_t i = 0; i < n; ++i) {
    float top = s->top_x[i] + paddle_vel(actions_a[i], p.paddle_speed);
    top = top < 0.0f ? 0.0f : (top > 1.0f ? 1.0f : top);
    float bot = s->bottom_x[i] + paddle_vel(actions_b[i], p.paddle_speed);
    bot = bot < 0.0f ? 0.0f : (bot > 1.0f ? 1.0f : bot);

    float vx =
        s->ball_vx[i] + p.enable_spin * p.magnus_factor * s->spin[i] * s->ball_vy[i];
    float vy = s->ball_vy[i];
    float x = s->ball_x[i] + vx;
    float y = s->ball_y[i] + vy;

    bool hit_left = x < 0.0f;
    bool hit_right = x > 1.0f;
    x = hit_left ? -x : (hit_right ? 2.0f - x : x);
    vx = (hit_left || hit_right) ? -vx : vx;

    bool cross_top = y < 0.0f;
    bool in_top = (top - half_w <= x) && (x <= top + half_w);
    bool hit_top = cross_top && in_top;
    bool miss_top = cross_top && !in_top;
    float ua = paddle_vel(actions_a[i], p.paddle_speed);
    float vn_t, vt_t, om_t;
    collide(vy, vx, ua, s->spin[i], p, &vn_t, &vt_t, &om_t);

    bool cross_bot = y > 1.0f;
    bool in_bot = (bot - half_w <= x) && (x <= bot + half_w);
    bool hit_bot = cross_bot && in_bot;
    bool miss_bot = cross_bot && !in_bot;
    float ub = paddle_vel(actions_b[i], p.paddle_speed);
    float vn_b, vt_b, om_b;
    collide(-vy, vx, ub, s->spin[i], p, &vn_b, &vt_b, &om_b);

    bool hit_any = hit_top || hit_bot;
    vy = hit_top ? vn_t : (hit_bot ? -vn_b : vy);
    vx = hit_top ? vt_t : (hit_bot ? vt_b : vx);
    float spin = hit_top ? om_t : (hit_bot ? om_b : s->spin[i]);
    y = hit_top ? 0.0f : (hit_bot ? 1.0f : y);

    int32_t bounce = s->bounce[i] + (hit_any ? 1 : 0);
    bool scale_now =
        hit_any && (bounce % scale_cfg->speed_scale_every == 0);
    float scale = scale_now ? 1.0f + scale_cfg->speed_increment : 1.0f;
    vx *= scale;
    vy *= scale;

    float rb = (miss_top ? 1.0f : 0.0f) - (miss_bot ? 1.0f : 0.0f);
    int32_t sa = s->score_a[i] + (miss_bot ? 1 : 0);
    int32_t sb = s->score_b[i] + (miss_top ? 1 : 0);
    bool done = (sa >= p.max_score) || (sb >= p.max_score);

    s->ball_x[i] = x;
    s->ball_y[i] = y;
    s->ball_vx[i] = vx;
    s->ball_vy[i] = vy;
    s->spin[i] = spin;
    s->top_x[i] = top;
    s->bottom_x[i] = bot;
    s->score_a[i] = sa;
    s->score_b[i] = sb;
    s->bounce[i] = bounce;
    s->t[i] += 1;
    reward_b[i] = rb;
    done_out[i] = done ? 1 : 0;
  }
}

// Multi-step rollout with ball-follower policies on both sides; per-env
// reward_b accumulated. Stops stepping an env once done (matches the
// reference trainers' episode loops). Returns number of finished envs.
int64_t pong_rollout_bot(const PongParams* params,
                         const PongScaleCfg* scale_cfg, PongStateSoA* s,
                         int64_t n, int32_t steps, float tolerance,
                         float* reward_acc, uint8_t* done_flags) {
  const PongParams p = *params;
  for (int64_t i = 0; i < n; ++i) {
    if (!done_flags[i]) reward_acc[i] = 0.0f;
  }
  for (int32_t step_i = 0; step_i < steps; ++step_i) {
    for (int64_t i = 0; i < n; ++i) {
      if (done_flags[i]) continue;
      float bx = s->ball_x[i];
      int32_t aa = bx < s->top_x[i] - tolerance
                       ? 0
                       : (bx > s->top_x[i] + tolerance ? 2 : 1);
      int32_t ab = bx < s->bottom_x[i] - tolerance
                       ? 0
                       : (bx > s->bottom_x[i] + tolerance ? 2 : 1);
      PongStateSoA one;
      one.ball_x = s->ball_x + i;
      one.ball_y = s->ball_y + i;
      one.ball_vx = s->ball_vx + i;
      one.ball_vy = s->ball_vy + i;
      one.spin = s->spin + i;
      one.top_x = s->top_x + i;
      one.bottom_x = s->bottom_x + i;
      one.score_a = s->score_a + i;
      one.score_b = s->score_b + i;
      one.bounce = s->bounce + i;
      one.t = s->t + i;
      float rb;
      uint8_t d;
      pong_step_batch(&p, scale_cfg, &one, &aa, &ab, 1, &rb, &d);
      reward_acc[i] += rb;
      done_flags[i] = d;
    }
  }
  int64_t finished = 0;
  for (int64_t i = 0; i < n; ++i) finished += done_flags[i] ? 1 : 0;
  return finished;
}

int32_t pong_engine_abi_version() { return 1; }

}  // extern "C"
