"""Precomputed TSP-nearest-neighbor trajectory generation, fully on device.

Replaces sim_node.generate_full_trajectory (sim_node.py:63-152): build a noisy
copy of the landmark map, order it with a nearest-neighbor TSP tour, then roll
the unicycle toward the tour goals for T steps, cycling through the tour. The
reference runs this once per launch in Python lists; here it is a pair of
lax.scans so thousands of worlds precompute their trajectories in parallel
under vmap.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from live_ekf_slam_tpu.config import Config
from live_ekf_slam_tpu.utils.geometry import wrap_angle


def _nn_tour(noisy_lm, start_pose, n_active):
    """Nearest-neighbor tour over landmark slots (sim_node.py:89-112).

    Ties and the strict-< scan of the reference both resolve to the lowest
    index, which argmin reproduces. Inactive slots are excluded via +inf.

    The visited set is maintained as a one-hot compare-OR and the current
    point is read back with a one-hot reduction rather than ``.at[].set`` /
    integer indexing, so the vmapped scan carries no batched scatter or
    gather: a vector compare + select per step
    (scripts/relabel_diag.py checks the tours against a CPU run).
    """
    n_cap = noisy_lm.shape[0]
    idx = jnp.arange(n_cap)
    active = idx < n_active
    big = jnp.float32(jnp.inf)

    d0 = jnp.linalg.norm(noisy_lm - start_pose[None, :2], axis=1)
    first = jnp.argmin(jnp.where(active, d0, big))

    def body(carry, _):
        cur, visited = carry
        cur_pt = jnp.sum(
            jnp.where((idx == cur)[:, None], noisy_lm, 0.0), axis=0
        )
        d = jnp.linalg.norm(noisy_lm - cur_pt[None], axis=1)
        d = jnp.where(active & ~visited, d, big)
        nxt = jnp.argmin(d)
        return (nxt, visited | (idx == nxt)), nxt

    visited0 = idx == first
    (_, _), rest = jax.lax.scan(body, (first, visited0), None, length=n_cap - 1)
    tour = jnp.concatenate([first[None], rest])
    # pad slots beyond n_active cycle back onto the active prefix
    tour = jnp.where(jnp.arange(n_cap) < n_active, tour, tour[0])
    return tour


def generate_trajectory(
    cfg: Config, landmarks, n_active, key, init_pose=None, return_tour=False
):
    """Returns (T, 2) commanded (fwd, ang) per tick (sim_node.py:113-138).

    landmarks: (N, 2) true map. The rough map used for planning gets uniform
    U(-landmark_noise, +landmark_noise) noise and is clamped to stay 1 m inside
    the display region (sim_node.py:82-87).

    return_tour: also return the (N,) TSP visit order. Relabeling each world's
    landmark ids by visit order (``landmarks[tour]``) makes visibility
    block-correlated across worlds — every world sees low ids early and high
    ids late — which the fused rollout kernel's per-landmark predication and
    seen-prefix growth bound exploit. Ids are arbitrary labels, so this is a
    pure data-layout choice: estimates are identical up to slot permutation.
    """
    t_total = cfg.num_iterations
    n_cap = landmarks.shape[0]
    pose0 = jnp.asarray(
        cfg.init_pose if init_pose is None else init_pose, jnp.float32
    )

    nz = cfg.trajectory_gen.landmark_noise
    u = jax.random.uniform(key, (n_cap, 2), jnp.float32, -1.0, 1.0)
    lo = -cfg.map.bound * cfg.plotter.display_region_mult + 1.0
    hi = cfg.map.bound * cfg.plotter.display_region_mult - 1.0
    noisy_lm = jnp.clip(landmarks + nz * u, lo, hi)

    tour = _nn_tour(noisy_lm, pose0, n_active)
    tour_pts = noisy_lm[tour]  # (N, 2) goal positions in visit order

    d_max = cfg.constraints.commands.d_max
    th_max = cfg.constraints.commands.th_max
    thresh = cfg.trajectory_gen.visitation_threshold

    slot_idx = jnp.arange(n_cap)

    def _goal_at(ptr):
        # one-hot reduction instead of tour_pts[ptr % n_active]: no batched
        # gather inside the vmapped scan (see _nn_tour docstring)
        k = ptr % jnp.maximum(n_active, 1)
        return jnp.sum(
            jnp.where((slot_idx == k)[:, None], tour_pts, 0.0), axis=0
        )

    def body(carry, _):
        x, ptr = carry
        goal = _goal_at(ptr)
        arrived = jnp.linalg.norm(x[:2] - goal) < thresh
        ptr = jnp.where(arrived, ptr + 1, ptr)
        goal = _goal_at(ptr)
        diff = goal - x[:2]
        d = jnp.minimum(jnp.linalg.norm(diff), d_max)
        gb = jnp.arctan2(diff[1], diff[0])
        hdg = wrap_angle(gb - x[2])
        hdg = jnp.where(jnp.abs(hdg) > th_max, th_max * jnp.sign(hdg), hdg)
        x = jnp.stack([x[0] + d * jnp.cos(x[2]), x[1] + d * jnp.sin(x[2]), x[2] + hdg])
        return (x, ptr), jnp.stack([d, hdg])

    (_, _), cmds = jax.lax.scan(
        body, (pose0, jnp.int32(0)), None, length=t_total
    )
    if return_tour:
        return cmds, tour
    return cmds
