"""Vectorized full-rollout sim streams: the whole T-tick simulation as
closed-form cumsums instead of a sequential scan.

Given the per-tick uniform noise draws, the reference simulator
(sim_node.py:209-250) is not actually sequential: the executed motions
(d_t, hdg_t) are elementwise in (cmd_t, u_t), the true heading is their
cumulative sum, the position is a cumsum of d_t * (cos, sin) of the heading,
and the visibility cull + noisy (r, b) emission are elementwise over
(tick, landmark). So the ENTIRE ground-truth rollout — poses and measurement
streams — materializes in O(T * N) vector ops with no lax.scan, which is what
lets pose-graph accumulation run at simulator speed (posegraph.assemble_streams
consumes these streams instead of per-tick graph writes).

RNG parity: draws are made with exactly the split discipline of the scan path
(eval/runner.py -> sim/world.py sim_step: per-tick key -> (k_move, k_sense),
uniform U(-1, 1) shaped (2,) and (2, N)), so a streams rollout with the same
per-world key reproduces the scan path's trajectories and measurements to
float tolerance.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from live_ekf_slam_tpu.config import Config
from live_ekf_slam_tpu.utils.geometry import wrap_angle


def sim_streams(cfg: Config, landmarks, n_active, cmds, key):
    """Full-rollout ground truth + measurement streams for ONE world
    (vmap over worlds).

    landmarks: (N, 2); cmds: (T, 2); key: the scan path's per-world rollout
    key (k_roll). Returns a dict:
      poses_true: (T, 3)  true pose AFTER tick t (sim_node.py:222)
      r:          (T, N)  noisy ranges to every landmark slot
      b:          (T, N)  noisy bearings
      vis:        (T, N)  visibility mask (range + FOV cull + active slots)
      noise_u:    (T, 2 + 2N) the raw U(-1, 1) draws in the fused
                  rollout's noise layout (d, hdg, r*N, b*N), so a rollout
                  fed noise_u sees the same world.
    """
    t_total = cmds.shape[0]
    n_cap = landmarks.shape[0]
    keys = jax.random.split(key, t_total)

    def draws(k):
        k_move, k_sense = jax.random.split(k)
        u_move = jax.random.uniform(k_move, (2,), jnp.float32, -1.0, 1.0)
        u_sense = jax.random.uniform(
            k_sense, (2, n_cap), jnp.float32, -1.0, 1.0
        )
        return u_move, u_sense

    u_move, u_sense = jax.vmap(draws)(keys)  # (T, 2), (T, 2, N)
    scale = cfg.sim_noise_scale

    # executed motion per tick (sim_node.py:216-220): uniform noise + clamps
    d = jnp.clip(
        cmds[:, 0] + cfg.process_noise.V_00 * scale * u_move[:, 0],
        0.0, cfg.constraints.commands.d_max,
    )
    hdg = jnp.clip(
        cmds[:, 1] + cfg.process_noise.V_11 * scale * u_move[:, 1],
        -cfg.constraints.commands.th_max, cfg.constraints.commands.th_max,
    )

    # move-then-turn (sim_node.py:222): the move uses the heading BEFORE this
    # tick's turn; the true heading is deliberately left unwrapped
    x0, y0, th0 = cfg.init_pose
    th_after = th0 + jnp.cumsum(hdg)
    th_before = jnp.concatenate([jnp.asarray([th0], jnp.float32), th_after[:-1]])
    x = x0 + jnp.cumsum(d * jnp.cos(th_before))
    y = y0 + jnp.cumsum(d * jnp.sin(th_before))
    poses_true = jnp.stack([x, y, th_after], axis=1)

    # sensing (sim_node.py:228-250), elementwise over (tick, landmark)
    dx = landmarks[None, :, 0] - x[:, None]
    dy = landmarks[None, :, 1] - y[:, None]
    r_true = jnp.sqrt(dx * dx + dy * dy)
    beta = wrap_angle(jnp.arctan2(dy, dx) - th_after[:, None])
    vis = (
        (r_true <= cfg.constraints.vision.range_max)
        & (beta > cfg.constraints.vision.fov_min)
        & (beta < cfg.constraints.vision.fov_max)
        & (jnp.arange(n_cap)[None, :] < n_active)
    )
    r_noisy = r_true + cfg.sensing_noise.W_00 * scale * u_sense[:, 0, :]
    b_noisy = beta + cfg.sensing_noise.W_11 * scale * u_sense[:, 1, :]

    noise_u = jnp.concatenate(
        [u_move, u_sense[:, 0, :], u_sense[:, 1, :]], axis=1
    )
    return {
        "poses_true": poses_true,
        "r": r_noisy,
        "b": b_noisy,
        "vis": vis,
        "noise_u": noise_u,
    }


def naive_deadreckon(cfg: Config, cmds):
    """The NaiveFilter's full pose history in closed form
    (filter.h:345-347: x += d cos(th); y += d sin(th); th = rem(th + ang)).

    The filter integrates the COMMANDED motion (no noise), so its whole
    trajectory is a cumsum; per-tick remainder-wrapping and one final wrap
    agree mod 2*pi, and the canonical representative is identical.

    cmds: (T, 2). Returns (T, 3): naive pose AFTER tick t.
    """
    x0, y0, th0 = cfg.init_pose
    th_after = th0 + jnp.cumsum(cmds[:, 1])
    th_before = jnp.concatenate(
        [jnp.asarray([th0], jnp.float32), th_after[:-1]]
    )
    x = x0 + jnp.cumsum(cmds[:, 0] * jnp.cos(th_before))
    y = y0 + jnp.cumsum(cmds[:, 0] * jnp.sin(th_before))
    return jnp.stack([x, y, wrap_angle(th_after)], axis=1)
