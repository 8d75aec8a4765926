"""Pose-graph SLAM: on-device factor accumulation + batched Gauss-Newton/LM.

Rebuild of pose_graph.cpp with GTSAM replaced by masked, fixed-shape solvers:

  * one prior factor on pose 0 (reference sigmas (1.3, 1.3, 1.2),
    pose_graph.cpp:83, compat mode; honest mode anchors at the true init
    uncertainty — see _prior_sigmas)
  * one SE(2) between-factor per tick from the commanded odometry
    Pose2(fwd, 0, ang) (pose_graph.cpp:222)
  * one bearing-range factor per detection, bearing noise first
    (pose_graph.cpp:174,53-54)
  * node values seeded from the secondary filter's online estimate
    (pose_graph.cpp:97-118,247)

The graph tensors are allocated at full capacity (T ticks, K measurement slots
per tick, N landmarks) with validity masks, so accumulation runs inside the
jitted/vmapped per-tick step with static shapes. Three solvers share the same
factor Jacobians:

  * `solve_schur_pcg` (default): Schur-eliminated landmarks + CG on the pose
    system preconditioned by its exact block-tridiagonal chain part
    (block-Thomas lax.scan) — O(T) per GN iteration, batches 1000s of worlds;
  * `solve_dense`: graduated dense LM over the (3(T+1)+2N)-dim normal
    equations (the reference implementation, `lax.while_loop` LM);
  * `solve_pcg_gn`: matrix-free Jacobi-PCG used incrementally per tick in
    solve_graph_every_iteration mode (warm starts only).

Between-factor residuals default to the SE(2) local-coordinates approximation
of GTSAM's Logmap; per-step motions are <= (0.1 m, 0.055 rad) so the
difference from the exact log map is far below the noise floor.
`PoseGraphConfig.exact_logmap` switches to the exact GTSAM Pose2 residual
Logmap(measured^-1 (pa^-1 pb)) with the V(theta)^-1 translation correction
(pose_graph.cpp:222); tests/test_posegraph.py quantifies the delta.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from live_ekf_slam_tpu.config import Config
from live_ekf_slam_tpu.core.noise import clip_uniform_moments
from live_ekf_slam_tpu.core.types import Measurements, PoseGraphState
from live_ekf_slam_tpu.ops.precision import dot32, einsum32
from live_ekf_slam_tpu.utils.geometry import wrap_angle


def init(cfg: Config, init_pose=None) -> PoseGraphState:
    t_cap = cfg.num_iterations
    n = cfg.num_landmark_slots
    k = cfg.num_meas_slots
    pose = jnp.asarray(
        cfg.init_pose if init_pose is None else init_pose, jnp.float32
    )
    return PoseGraphState(
        poses_init=jnp.zeros((t_cap + 1, 3), jnp.float32).at[0].set(pose),
        lms_init=jnp.zeros((n, 2), jnp.float32),
        odom=jnp.zeros((t_cap, 2), jnp.float32),
        odom_valid=jnp.zeros(t_cap, bool),
        meas_rb=jnp.zeros((t_cap, k, 2), jnp.float32),
        meas_lm=jnp.zeros((t_cap, k), jnp.int32),
        meas_valid=jnp.zeros((t_cap, k), bool),
        ids=jnp.full(n, -1, jnp.int32),
        M=jnp.int32(0),
        timestep=jnp.int32(0),
        cur_pose=pose,
        poses_sol=jnp.zeros((t_cap + 1, 3), jnp.float32).at[0].set(pose),
        lms_sol=jnp.zeros((n, 2), jnp.float32),
        solved=jnp.asarray(False),
    )


def update_naive_estimate(
    s: PoseGraphState,
    secondary_pose,
    secondary_lms=None,
    secondary_ids=None,
    secondary_m=None,
    update_landmarks: bool = False,
) -> PoseGraphState:
    """updateNaiveVehPoseEstimate (pose_graph.cpp:97-119): store the secondary
    filter's current pose to seed the next graph node.

    With `update_landmarks` (PoseGraphConfig.update_landmarks_after_adding,
    pose_graph.cpp:111-118) and a SLAM secondary, the graph's initial landmark
    values are refreshed each tick from the secondary's landmark estimates
    (matched by id). The reference updates `initial_estimate`, which in
    iterative mode also holds the solve feedback — so both lms_init and
    lms_sol are refreshed here.
    """
    s = s.replace(cur_pose=secondary_pose[:3])
    if not update_landmarks or secondary_lms is None:
        return s
    n_cap = s.ids.shape[0]
    slot_idx = jnp.arange(n_cap)
    sec_idx = jnp.arange(secondary_ids.shape[0])
    # graph slot i (id gid) <- secondary slot j with ids[j] == gid
    match = (secondary_ids[None, :] == s.ids[:, None]) & (
        sec_idx[None, :] < secondary_m
    )  # (N_graph, N_sec)
    found = jnp.any(match, axis=1) & (slot_idx < s.M)
    # one-hot contraction, not secondary_lms[argmax(match)]: a batched
    # gather under vmap is the scatter-class slowness this module avoids
    # everywhere else (ids are unique, so each row of match has <=1 True;
    # unmatched rows give 0 and are masked by `found`)
    est = einsum32(
        "ns,sd->nd", match.astype(jnp.float32), secondary_lms
    )  # (N_graph, 2)
    lms_init = jnp.where(found[:, None], est, s.lms_init)
    lms_sol = jnp.where(found[:, None], est, s.lms_sol)
    return s.replace(lms_init=lms_init, lms_sol=lms_sol)


def _set_row(arr, t, new_row, live):
    """arr[t] = new_row (only where live), spelled as slice-level DS/DUS.

    When t is an UNBATCHED tick (threaded through the Monte-Carlo scan as
    plain xs, identical across worlds), vmap keeps this a single
    dynamic-update-slice on the batched tensor — the whole (B, T, ...) graph
    buffer is never re-materialized. The round-1 spelling (`.at[t].set` with
    the per-world timestep) lowered to a scatter under vmap and made graph
    accumulation ~100x slower than the rest of the step.
    """
    old = jax.lax.dynamic_slice_in_dim(arr, t, 1, axis=0)
    new = jnp.where(live, new_row[None], old)
    return jax.lax.dynamic_update_slice_in_dim(arr, new, t, axis=0)


def update(
    cfg: Config, s: PoseGraphState, cmd, meas: Measurements, tick=None
) -> PoseGraphState:
    """One graph-building tick (pose_graph.cpp:199-271), minus the solve.

    The final-tick solve (pose_graph.cpp:208-214) runs outside the scan via
    `solve()`; accumulation past capacity is masked off exactly like the
    reference's stopping criterion.

    tick: the global tick index, when the caller can supply it UNBATCHED
    (all worlds tick in lockstep, so it always equals s.timestep). Passing it
    keeps the graph-tensor writes scatter-free under vmap (see _set_row).
    """
    t_cap = s.odom.shape[0]
    t = s.timestep if tick is None else jnp.asarray(tick, jnp.int32)
    live = t + 1 < jnp.int32(cfg.num_iterations)

    odom = _set_row(s.odom, t, jnp.stack([cmd[0], cmd[1]]), live)
    odom_valid = _set_row(s.odom_valid, t, jnp.asarray(True), live)
    t_new = jnp.where(live, jnp.minimum(t + 1, t_cap), t)
    poses_init = _set_row(s.poses_init, t_new, s.cur_pose, live)

    # measurements: resolve landmark slots, seed first sightings, add factors
    n_cap = s.ids.shape[0]
    slot_idx = jnp.arange(n_cap)

    k = s.meas_rb.shape[1]
    kidx = jnp.arange(k)

    def meas_body(carry, slot):
        ids, m, lms_init, row_rb, row_lm, row_valid = carry
        mid, r, b, valid, j = slot
        valid = valid & live
        match = (ids == mid) & (slot_idx < m)
        found = jnp.any(match)
        idx = jnp.where(found, jnp.argmax(match), m)
        is_new = valid & ~found & (m < n_cap)
        # first sighting: seed global position from the secondary estimate
        # (pose_graph.cpp:163-169). One-hot writes (no scatter under vmap).
        seed = jnp.stack(
            [
                s.cur_pose[0] + r * jnp.cos(s.cur_pose[2] + b),
                s.cur_pose[1] + r * jnp.sin(s.cur_pose[2] + b),
            ]
        )
        at_m = slot_idx == m
        lms_init = jnp.where(
            (is_new & at_m)[:, None], seed[None, :], lms_init
        )
        ids = jnp.where(is_new & at_m, mid, ids)
        m = jnp.where(is_new, m + 1, m)
        # gate on insertability: a never-seen landmark arriving with the slot
        # table full (m == n_cap) has idx == n_cap, and writing its row would
        # make downstream clamped gathers (lms[s.meas_lm]) silently bind the
        # factor to slot n_cap-1 — drop it instead (scatter paths already do)
        at_j = valid & (found | is_new) & (kidx == j)
        row_rb = jnp.where(at_j[:, None], jnp.stack([r, b])[None, :], row_rb)
        row_lm = jnp.where(at_j, idx, row_lm)
        row_valid = row_valid | at_j
        return (ids, m, lms_init, row_rb, row_lm, row_valid), None

    carry0 = (
        s.ids,
        s.M,
        s.lms_init,
        jnp.zeros((k, 2), jnp.float32),
        jnp.zeros(k, jnp.int32),
        jnp.zeros(k, bool),
    )
    (ids, m, lms_init, row_rb, row_lm, row_valid), _ = jax.lax.scan(
        meas_body, carry0,
        (meas.ids, meas.r, meas.b, meas.valid, jnp.arange(k)),
    )
    # factors attach to the *new* pose node (timestep was incremented first,
    # pose_graph.cpp:240-259); row index in the tensors is t_new - 1 = t.
    meas_rb = _set_row(s.meas_rb, t, row_rb, live)
    meas_lm = _set_row(s.meas_lm, t, row_lm, live)
    meas_valid = _set_row(s.meas_valid, t, row_valid, live)

    return s.replace(
        odom=odom,
        odom_valid=odom_valid,
        poses_init=poses_init,
        meas_rb=meas_rb,
        meas_lm=meas_lm,
        meas_valid=meas_valid,
        ids=ids,
        M=m,
        lms_init=lms_init,
        timestep=t_new,
    )


def assemble_streams(cfg: Config, est_poses, r, b, vis, cmds) -> PoseGraphState:
    """Build the ENTIRE pose graph from full-rollout streams in vector ops —
    the O(T*N) replacement for T sequential `update` calls (the accumulation
    path that capped the XLA runner at ~1.8k steps/s/world).

    Inputs for one world (vmap over worlds):
      est_poses: (T, 3) secondary-filter pose AFTER tick t (the node seeds,
                 pose_graph.cpp:97-118,247)
      r, b:      (T, N) noisy range/bearing streams (slot = landmark id)
      vis:       (T, N) visibility mask
      cmds:      (T, 2) commanded odometry (the between-factor values,
                 pose_graph.cpp:220-222)

    Exactly reproduces the PoseGraphState the per-tick `update` scan builds
    (parity-tested in tests/test_posegraph.py): tick T-1 solves instead of
    adding (live mask), landmark slots are assigned in first-sighting order
    with same-tick ties broken by ascending id (the simulator emits
    measurements in id order, sim_node.py:231-243), and first sightings seed
    from the secondary pose at the sighting tick (pose_graph.cpp:163-169).

    Requires num_meas_slots >= N (no per-tick measurement compaction), which
    is how every benchmark config runs.
    """
    t_cap = cfg.num_iterations
    n_cap = vis.shape[1]
    k = cfg.num_meas_slots
    if k < n_cap:
        raise ValueError(
            "assemble_streams needs num_meas_slots >= landmark slots "
            f"(got {k} < {n_cap})"
        )
    if est_poses.shape[0] != t_cap:
        raise ValueError("stream length must equal cfg.num_iterations")
    tidx = jnp.arange(t_cap)
    live = tidx < t_cap - 1  # the final tick solves instead of adding
    vis_live = vis & live[:, None]

    # ---- first-sighting slot assignment (meas_body insertion order) ----
    first_t = jnp.where(
        jnp.any(vis_live, axis=0),
        jnp.argmax(vis_live, axis=0),
        t_cap,  # never seen
    )  # (N,)
    order = jnp.argsort(first_t, stable=True)  # ties -> ascending id
    slot_of_id = jnp.argsort(order, stable=True)  # inverse permutation
    seen = first_t < t_cap
    m = jnp.sum(seen.astype(jnp.int32))
    slot_idx = jnp.arange(n_cap)
    ids = jnp.where(slot_idx < m, order, -1).astype(jnp.int32)

    # ---- landmark seeds: secondary pose at the first-sighting tick ----
    tf = jnp.clip(first_t, 0, t_cap - 1)
    p_at = est_poses[tf]  # (N, 3) pose after tick first_t, per landmark id
    r_at = jnp.take_along_axis(r, tf[None, :], axis=0)[0]
    b_at = jnp.take_along_axis(b, tf[None, :], axis=0)[0]
    seed_x = p_at[:, 0] + r_at * jnp.cos(p_at[:, 2] + b_at)
    seed_y = p_at[:, 1] + r_at * jnp.sin(p_at[:, 2] + b_at)
    seeds_by_id = jnp.stack([seed_x, seed_y], axis=1)  # (N, 2) by id
    lms_init = jnp.where(
        (slot_idx < m)[:, None], seeds_by_id[order], 0.0
    )

    # ---- node values and odometry ----
    pose0 = jnp.asarray(cfg.init_pose, jnp.float32)
    poses_init = jnp.concatenate(
        [
            pose0[None],
            jnp.where(live[:, None], est_poses, 0.0),
            jnp.zeros((1, 3), jnp.float32),
        ],
        axis=0,
    )[: t_cap + 1]
    odom = jnp.where(live[:, None], cmds, 0.0)
    odom_valid = live

    # ---- measurement factor tensors (slot j = landmark id j, the
    # simulator's id-order emission; invalid slots zeroed like meas_body) ----
    pad = k - n_cap
    rb = jnp.stack([r, b], axis=-1)
    meas_rb = jnp.where(vis_live[..., None], rb, 0.0)
    meas_lm = jnp.where(vis_live, slot_of_id[None, :], 0).astype(jnp.int32)
    meas_valid = vis_live
    if pad:
        meas_rb = jnp.pad(meas_rb, ((0, 0), (0, pad), (0, 0)))
        meas_lm = jnp.pad(meas_lm, ((0, 0), (0, pad)))
        meas_valid = jnp.pad(meas_valid, ((0, 0), (0, pad)))

    return PoseGraphState(
        poses_init=poses_init,
        lms_init=lms_init,
        odom=odom,
        odom_valid=odom_valid,
        meas_rb=meas_rb,
        meas_lm=meas_lm,
        meas_valid=meas_valid,
        ids=ids,
        M=m.astype(jnp.int32),
        timestep=jnp.int32(t_cap - 1),
        cur_pose=est_poses[-1],
        poses_sol=jnp.zeros((t_cap + 1, 3), jnp.float32).at[0].set(pose0),
        lms_sol=jnp.zeros((n_cap, 2), jnp.float32),
        solved=jnp.asarray(False),
    )


# ----------------------------------------------------------------------
# Gauss-Newton / Levenberg-Marquardt solve
# ----------------------------------------------------------------------

def _prior_sigmas(cfg: Config):
    """Pose-0 anchor sigmas: the reference's (1.3, 1.3, 1.2)
    (pose_graph.cpp:83) in compat mode; the true initialization uncertainty
    in honest mode (see PoseGraphConfig.prior_sigmas_honest — the weak
    reference prior leaves the global gauge nearly free and dominated PGS
    absolute error)."""
    if cfg.compat.pg_variances_as_sigmas:
        return jnp.asarray(cfg.pose_graph.prior_sigmas, jnp.float32)
    return jnp.asarray(cfg.pose_graph.prior_sigmas_honest, jnp.float32)


def _noise_sigmas(cfg: Config, meas_scale: float = 1.0):
    (v00, v11), (w00, w11) = cfg.filter_noise()
    if cfg.compat.pg_variances_as_sigmas:
        # GTSAM models are built from variances passed as sigmas
        # (pose_graph.cpp:52-54).
        odom_s = (v00, v00, v11)
        meas_s = (w11, w00)  # (bearing, range)
    else:
        # honest model of the simulator's actual noise: U(-V, V) has std
        # V/sqrt(3); the unicycle has NO lateral slip, so the lateral sigma is
        # a small regularizer rather than sqrt(V) (which lets the trajectory
        # slide sideways to overfit measurement noise and diverge).
        s3 = 3.0 ** 0.5
        odom_s = (v00 / s3, 1e-3, v11 / s3)
        meas_s = (w11 / s3, w00 / s3)
    meas_s = (meas_s[0] * meas_scale, meas_s[1] * meas_scale)
    return odom_s, meas_s


# canonical implementation lives in core/noise.py (shared with the
# EKF/UKF calibrated-motion mode); the formula is fp32-sensitive (centered
# truncated-uniform moments) and must not fork
_clip_uniform_moments = clip_uniform_moments


def _odom_moments(cfg: Config, odom):
    """Clip-aware per-tick odometry moments (honest mode only).

    The simulator clips the noisy command (sim_node.py:219-220): forward to
    [0, d_max], heading to [-th_max, th_max]. The TSP trajectory saturates
    both channels much of the time, where the executed motion is (a) biased
    toward the interior (modeling the forward bias cut default-mode PGS error
    0.34 -> 0.23 m at reference scale) and (b) LESS noisy than the unclipped
    U(-V, V): std drops from V/sqrt(3) to ~0.32 V at full saturation. Using
    the exact per-tick mean and std weights each between-factor by the noise
    it actually saw.

    Returns (eff (T, 2) expected executed [fwd, hdg], sig (T, 3) residual
    sigmas [fwd, lateral, hdg]). Compat mode returns the reference/GTSAM
    factors exactly (raw commands, variance-as-sigma scalars).
    """
    t_cap = odom.shape[0]
    (v00, v11), _ = cfg.filter_noise()
    if cfg.compat.pg_variances_as_sigmas:
        # GTSAM models built from variances passed as sigmas
        # (pose_graph.cpp:52-54), raw commanded motion as the mean
        sig = jnp.broadcast_to(
            jnp.asarray([v00, v00, v11], jnp.float32), (t_cap, 3)
        )
        return odom, sig
    v_fwd = cfg.process_noise.V_00
    v_hdg = cfg.process_noise.V_11
    s3 = 3.0 ** 0.5
    if v_fwd > 0.0:
        eff_d, sig_d = _clip_uniform_moments(
            odom[:, 0], v_fwd, 0.0, cfg.constraints.commands.d_max
        )
        # a fully-saturated tick has std -> 0; floor at 10% of the unclipped
        # std so no single factor becomes near-infinitely stiff
        sig_d = jnp.maximum(sig_d, 0.1 * v_fwd / s3)
    else:
        eff_d, sig_d = odom[:, 0], jnp.full((t_cap,), 1e-6, jnp.float32)
    th_max = cfg.constraints.commands.th_max
    if v_hdg > 0.0:
        eff_th, sig_th = _clip_uniform_moments(
            odom[:, 1], v_hdg, -th_max, th_max
        )
        sig_th = jnp.maximum(sig_th, 0.1 * v_hdg / s3)
    else:
        eff_th, sig_th = odom[:, 1], jnp.full((t_cap,), 1e-6, jnp.float32)
    # the unicycle has NO lateral slip: the lateral sigma is a small
    # regularizer rather than sqrt(V) (which lets the trajectory slide
    # sideways to overfit measurement noise and diverge)
    sig_lat = jnp.full((t_cap,), 1e-3, jnp.float32)
    eff = jnp.stack([eff_d, eff_th], axis=1)
    sig = jnp.stack([sig_d, sig_lat, sig_th], axis=1)
    return eff, sig


def _logmap_vinv(th):
    """V(theta)^-1 of the SE(2) log map, as (a, b) with
    V^-1 = [[a, b], [-b, a]] — small-angle-safe.

    Pose2::Logmap(t, R(theta)) = (V^-1 t, theta) with
    V = [[sin/th, -(1-cos)/th], [(1-cos)/th, sin/th]]; inverting the 2x2
    rotation-scaled block gives a = A/(A^2+B^2), b = B/(A^2+B^2) for
    A = sin(th)/th, B = (1-cos(th))/th (Taylor fallbacks below 1e-4)."""
    small = jnp.abs(th) < 1e-4
    th_safe = jnp.where(small, 1.0, th)
    a = jnp.where(small, 1.0 - th * th / 6.0, jnp.sin(th) / th_safe)
    b = jnp.where(
        small, th / 2.0 - th ** 3 / 24.0, (1.0 - jnp.cos(th)) / th_safe
    )
    den = a * a + b * b
    return a / den, b / den


def _residuals(cfg: Config, s: PoseGraphState, poses, lms, meas_scale=1.0):
    """All whitened residuals + masks, vectorized over factors."""
    odom_eff, odom_sig = _odom_moments(cfg, s.odom)
    _, meas_s = _noise_sigmas(cfg, meas_scale)
    prior_s = _prior_sigmas(cfg)

    # prior on pose 0
    p0 = s.poses_init[0]
    r_prior = jnp.concatenate(
        [poses[0, :2] - p0[:2], wrap_angle(poses[0, 2] - p0[2])[None]]
    ) / prior_s

    # odometry between-factors t -> t+1
    pa = poses[:-1]
    pb = poses[1:]
    ca, sa = jnp.cos(pa[:, 2]), jnp.sin(pa[:, 2])
    dx = pb[:, 0] - pa[:, 0]
    dy = pb[:, 1] - pa[:, 1]
    lx = ca * dx + sa * dy
    ly = -sa * dx + ca * dy
    lth = wrap_angle(pb[:, 2] - pa[:, 2])
    if cfg.pose_graph.exact_logmap:
        # GTSAM Pose2 between-factor error (pose_graph.cpp:222):
        # Logmap(measured^-1 * (pa^-1 pb)) — compose with the inverse
        # measured pose (eff_d, 0, eff_th), then apply the V^-1 translation
        # correction of the exact SE(2) log map.
        m_th = odom_eff[:, 1]
        cm, sm = jnp.cos(m_th), jnp.sin(m_th)
        ex_ = lx - odom_eff[:, 0]
        ey_ = ly  # measured y component is 0
        rx = cm * ex_ + sm * ey_
        ry = -sm * ex_ + cm * ey_
        rth = wrap_angle(lth - m_th)
        va, vb = _logmap_vinv(rth)
        r_odom = jnp.stack(
            [
                (va * rx + vb * ry) / odom_sig[:, 0],
                (-vb * rx + va * ry) / odom_sig[:, 1],
                rth / odom_sig[:, 2],
            ],
            axis=1,
        )
    else:
        # local-coordinates approximation (difference in pose-a frame)
        r_odom = jnp.stack(
            [
                (lx - odom_eff[:, 0]) / odom_sig[:, 0],
                (ly - 0.0) / odom_sig[:, 1],
                wrap_angle(lth - odom_eff[:, 1]) / odom_sig[:, 2],
            ],
            axis=1,
        )
    r_odom = jnp.where(s.odom_valid[:, None], r_odom, 0.0)

    # bearing-range factors: measurement at row t attaches to pose t+1
    t_cap, k = s.meas_valid.shape
    pt = poses[1:][:, None, :]  # (T, 1, 3)
    lm = lms[s.meas_lm]  # (T, K, 2)
    # double-where: masked slots get unit geometry BEFORE sqrt/atan2 so
    # gradients through the masked residuals stay finite.
    mdx = jnp.where(s.meas_valid, lm[..., 0] - pt[..., 0], 1.0)
    mdy = jnp.where(s.meas_valid, lm[..., 1] - pt[..., 1], 0.0)
    rng = jnp.sqrt(mdx * mdx + mdy * mdy)
    rng_safe = jnp.where(rng > 0, rng, 1.0)
    brg = wrap_angle(jnp.arctan2(mdy, mdx) - pt[..., 2])
    r_meas = jnp.stack(
        [
            wrap_angle(brg - s.meas_rb[..., 1]) / meas_s[0],
            (rng - s.meas_rb[..., 0]) / meas_s[1],
        ],
        axis=-1,
    )  # (T, K, 2) — (bearing, range) order, pose_graph.cpp:53-54
    r_meas = jnp.where(s.meas_valid[..., None], r_meas, 0.0)
    return r_prior, r_odom, r_meas, rng_safe, (mdx, mdy)


def graph_error(cfg: Config, s: PoseGraphState, poses, lms, meas_scale=1.0):
    """0.5 * sum of squared whitened residuals (GTSAM's error convention)."""
    r_prior, r_odom, r_meas, _, _ = _residuals(cfg, s, poses, lms, meas_scale)
    return 0.5 * (
        jnp.sum(r_prior ** 2) + jnp.sum(r_odom ** 2) + jnp.sum(r_meas ** 2)
    )


def _jacobians(cfg: Config, s: PoseGraphState, poses, lms, meas_scale=1.0):
    """Whitened factor Jacobians + residuals, shared by the dense assembler
    and the matrix-free PCG solver."""
    odom_eff, odom_sig = _odom_moments(cfg, s.odom)
    _, meas_s = _noise_sigmas(cfg, meas_scale)
    prior_s = _prior_sigmas(cfg)

    r_prior, r_odom, r_meas, rng_safe, (mdx, mdy) = _residuals(
        cfg, s, poses, lms, meas_scale
    )

    # ---- odometry factors (vectorized over T) ----
    pa = poses[:-1]
    ca, sa = jnp.cos(pa[:, 2]), jnp.sin(pa[:, 2])
    dx = poses[1:, 0] - pa[:, 0]
    dy = poses[1:, 1] - pa[:, 1]
    zeros = jnp.zeros_like(ca)
    ones = jnp.ones_like(ca)
    # d residual / d pose_t (before whitening)
    ja = jnp.stack(
        [
            jnp.stack([-ca, -sa, -sa * dx + ca * dy], axis=-1),
            jnp.stack([sa, -ca, -ca * dx - sa * dy], axis=-1),
            jnp.stack([zeros, zeros, -ones], axis=-1),
        ],
        axis=1,
    )  # (T, 3, 3)
    jb = jnp.stack(
        [
            jnp.stack([ca, sa, zeros], axis=-1),
            jnp.stack([-sa, ca, zeros], axis=-1),
            jnp.stack([zeros, zeros, ones], axis=-1),
        ],
        axis=1,
    )
    if cfg.pose_graph.exact_logmap:
        # exact-residual translation rows pick up the constant factor
        # M2 = V^-1(rel_th) R(-m_th) (see _residuals); the d(V^-1)/d(th)
        # terms are proportional to the residual itself and are dropped, the
        # standard Gauss-Newton small-residual approximation (GTSAM keeps
        # them; at <=0.055 rad steps they are O(residual * th) ~ 1e-5)
        m_th = odom_eff[:, 1]
        cm, sm = jnp.cos(m_th), jnp.sin(m_th)
        lth = wrap_angle(poses[1:, 2] - pa[:, 2])
        rth = wrap_angle(lth - m_th)
        va, vb = _logmap_vinv(rth)
        m00 = va * cm - vb * sm
        m01 = va * sm + vb * cm
        m10 = -vb * cm - va * sm
        m11 = -vb * sm + va * cm
        m2 = jnp.stack(
            [
                jnp.stack([m00, m01], axis=-1),
                jnp.stack([m10, m11], axis=-1),
            ],
            axis=1,
        )  # (T, 2, 2)
        ja = ja.at[:, :2, :].set(einsum32("tpq,tqi->tpi", m2, ja[:, :2, :]))
        jb = jb.at[:, :2, :].set(einsum32("tpq,tqi->tpi", m2, jb[:, :2, :]))
    inv_od = 1.0 / odom_sig  # (T, 3) per-tick whitening (clip-aware)
    mask_od = s.odom_valid.astype(jnp.float32)[:, None, None]
    ja = ja * inv_od[:, :, None] * mask_od
    jb = jb * inv_od[:, :, None] * mask_od

    # ---- bearing-range factors: (T, K, 2, 5) tensor built only on demand
    # (the dense assembler needs it; the matrix-free path uses the scalar
    # coefficient form in _meas_coeffs to avoid the large intermediate) ----
    def make_jm():
        valid = s.meas_valid.astype(jnp.float32)
        r2 = rng_safe * rng_safe
        # rows: (bearing, range); cols: (px, py, pth, lx, ly)
        jm = jnp.stack(
            [
                jnp.stack(
                    [mdy / r2, -mdx / r2, -jnp.ones_like(rng_safe),
                     -mdy / r2, mdx / r2],
                    axis=-1,
                )
                / meas_s[0],
                jnp.stack(
                    [-mdx / rng_safe, -mdy / rng_safe,
                     jnp.zeros_like(rng_safe),
                     mdx / rng_safe, mdy / rng_safe],
                    axis=-1,
                )
                / meas_s[1],
            ],
            axis=2,
        )  # (T, K, 2, 5)
        return jm * valid[..., None, None]

    inv_pr = 1.0 / prior_s
    t_cap = s.odom.shape[0]
    n_cap = s.lms_init.shape[0]
    pose_active = jnp.arange(t_cap + 1) <= s.timestep
    lm_active = jnp.arange(n_cap) < s.M
    return {
        "inv_pr": inv_pr,
        "r_prior": r_prior,
        "ja": ja,
        "jb": jb,
        "r_odom": r_odom,
        "make_jm": make_jm,
        "r_meas": r_meas,
        "p0": s.poses_init[0],
        "pose_active": pose_active,
        "lm_active": lm_active,
    }


def _meas_coeffs(cfg: Config, s: PoseGraphState, poses, lms, meas_scale):
    """Bearing-range Jacobian rows as 5 scalar (T, K) coefficient arrays
    (instead of a (T, K, 2, 5) tensor, which at batch 32 x T=1000 was a
    256 MB intermediate per graph batch).

    rows (whitened): bearing = [ab, bb, cb, -ab, -bb],
                     range   = [ar, br,  0, -ar, -br]
    over variables (px, py, pth, lx, ly).
    """
    _, meas_s = _noise_sigmas(cfg, meas_scale)
    _, _, r_meas, rng_safe, (mdx, mdy) = _residuals(
        cfg, s, poses, lms, meas_scale
    )
    valid = s.meas_valid.astype(jnp.float32)
    r2 = rng_safe * rng_safe
    ab = mdy / r2 / meas_s[0] * valid
    bb = -mdx / r2 / meas_s[0] * valid
    cb = -1.0 / meas_s[0] * valid
    ar = -mdx / rng_safe / meas_s[1] * valid
    br = -mdy / rng_safe / meas_s[1] * valid
    return (ab, bb, cb, ar, br), r_meas


def _meas_back(s: PoseGraphState, coeffs, u_b, u_r, op, ol):
    """Accumulate J_meas^T u into the pose/landmark blocks."""
    ab, bb, cb, ar, br = coeffs
    px = ab * u_b + ar * u_r  # (T, K)
    py = bb * u_b + br * u_r
    pth = cb * u_b
    op = op.at[1:].add(
        jnp.stack(
            [jnp.sum(px, axis=1), jnp.sum(py, axis=1), jnp.sum(pth, axis=1)],
            axis=-1,
        )
    )
    ol = ol.at[s.meas_lm.reshape(-1)].add(
        jnp.stack([-px.reshape(-1), -py.reshape(-1)], axis=-1)
    )
    return op, ol


def _grad(cfg: Config, s: PoseGraphState, jac, coeffs, r_meas):
    """g = -J^T r split into pose (T+1, 3) and landmark (N, 2) blocks."""
    t_cap = s.odom.shape[0]
    n_cap = s.lms_init.shape[0]
    gp = jnp.zeros((t_cap + 1, 3), jnp.float32)
    gl = jnp.zeros((n_cap, 2), jnp.float32)
    gp = gp.at[0].add(-jac["inv_pr"] * jac["r_prior"])
    gp = gp.at[:-1].add(-einsum32("tri,tr->ti", jac["ja"], jac["r_odom"]))
    gp = gp.at[1:].add(-einsum32("tri,tr->ti", jac["jb"], jac["r_odom"]))
    return _meas_back(s, coeffs, -r_meas[..., 0], -r_meas[..., 1], gp, gl)


def _hv(s: PoseGraphState, jac, coeffs, vp, vl):
    """Matrix-free H v = J^T (J v) with H the Gauss-Newton Hessian."""
    t_cap = s.odom.shape[0]
    n_cap = s.lms_init.shape[0]
    op = jnp.zeros((t_cap + 1, 3), jnp.float32)
    ol = jnp.zeros((n_cap, 2), jnp.float32)
    # prior
    op = op.at[0].add(jac["inv_pr"] ** 2 * vp[0])
    # odometry: u = Ja v_t + Jb v_{t+1}
    u = einsum32("tri,ti->tr", jac["ja"], vp[:-1]) + einsum32(
        "tri,ti->tr", jac["jb"], vp[1:]
    )
    op = op.at[:-1].add(einsum32("tri,tr->ti", jac["ja"], u))
    op = op.at[1:].add(einsum32("tri,tr->ti", jac["jb"], u))
    # bearing-range: u = J_meas [v_pose(t+1); v_lm]
    ab, bb, cb, ar, br = coeffs
    vpx = vp[1:, 0][:, None]
    vpy = vp[1:, 1][:, None]
    vpth = vp[1:, 2][:, None]
    vlg = vl[s.meas_lm]  # (T, K, 2)
    ex = vpx - vlg[..., 0]
    ey = vpy - vlg[..., 1]
    u_b = ab * ex + bb * ey + cb * vpth
    u_r = ar * ex + br * ey
    return _meas_back(s, coeffs, u_b, u_r, op, ol)


def _h_diag(s: PoseGraphState, jac, coeffs):
    """diag(J^T J) split into pose/landmark blocks (Jacobi preconditioner)."""
    t_cap = s.odom.shape[0]
    n_cap = s.lms_init.shape[0]
    dp = jnp.zeros((t_cap + 1, 3), jnp.float32)
    dl = jnp.zeros((n_cap, 2), jnp.float32)
    dp = dp.at[0].add(jac["inv_pr"] ** 2)
    dp = dp.at[:-1].add(einsum32("tri,tri->ti", jac["ja"], jac["ja"]))
    dp = dp.at[1:].add(einsum32("tri,tri->ti", jac["jb"], jac["jb"]))
    ab, bb, cb, ar, br = coeffs
    qx = ab * ab + ar * ar  # (T, K)
    qy = bb * bb + br * br
    qth = cb * cb
    dp = dp.at[1:].add(
        jnp.stack(
            [jnp.sum(qx, axis=1), jnp.sum(qy, axis=1), jnp.sum(qth, axis=1)],
            axis=-1,
        )
    )
    dl = dl.at[s.meas_lm.reshape(-1)].add(
        jnp.stack([qx.reshape(-1), qy.reshape(-1)], axis=-1)
    )
    return dp, dl


def _assemble(cfg: Config, s: PoseGraphState, poses, lms, meas_scale=1.0):
    """Dense damped-GN system: returns (H, g) with H = J^T J, g = -J^T r."""
    t_cap = s.odom.shape[0]
    n_cap = s.lms_init.shape[0]
    dim = 3 * (t_cap + 1) + 2 * n_cap

    jac = _jacobians(cfg, s, poses, lms, meas_scale)

    h = jnp.zeros((dim, dim), jnp.float32)
    g = jnp.zeros(dim, jnp.float32)

    # ---- prior: J = diag(1/sigma) on pose-0 block ----
    inv_pr = jac["inv_pr"]
    h = h.at[jnp.arange(3), jnp.arange(3)].add(inv_pr ** 2)
    g = g.at[:3].add(-inv_pr * jac["r_prior"])

    # ---- odometry factors ----
    j66 = jnp.concatenate([jac["ja"], jac["jb"]], axis=2)  # (T, 3, 6)
    h66 = einsum32("tri,trj->tij", j66, j66)  # (T, 6, 6)
    g6 = -einsum32("tri,tr->ti", j66, jac["r_odom"])  # (T, 6)
    base = 3 * jnp.arange(t_cap)
    ix6 = base[:, None] + jnp.arange(6)[None, :]  # (T, 6) var indices
    h = h.at[ix6[:, :, None], ix6[:, None, :]].add(h66)
    g = g.at[ix6].add(g6)

    # ---- bearing-range factors (flattened over T*K) ----
    t_idx = jnp.broadcast_to(
        jnp.arange(t_cap)[:, None], s.meas_valid.shape
    ).reshape(-1)
    lm_idx = s.meas_lm.reshape(-1)
    jm = jac["make_jm"]().reshape(-1, 2, 5)
    h55 = einsum32("fri,frj->fij", jm, jm)
    g5 = -einsum32("fri,fr->fi", jm, jac["r_meas"].reshape(-1, 2))
    pose_base = 3 * (t_idx + 1)
    lm_base = 3 * (t_cap + 1) + 2 * lm_idx
    ix5 = jnp.concatenate(
        [
            pose_base[:, None] + jnp.arange(3)[None, :],
            lm_base[:, None] + jnp.arange(2)[None, :],
        ],
        axis=1,
    )  # (F, 5)
    h = h.at[ix5[:, :, None], ix5[:, None, :]].add(h55)
    g = g.at[ix5].add(g5)

    # ---- inactive variables: pin with identity rows ----
    var_active = jnp.concatenate(
        [jnp.repeat(jac["pose_active"], 3), jnp.repeat(jac["lm_active"], 2)]
    )
    diag_fix = jnp.where(var_active, 0.0, 1.0)
    h = h + jnp.diag(diag_fix)
    g = jnp.where(var_active, g, 0.0)
    return h, g, var_active


def chordal_init(cfg: Config, s: PoseGraphState):
    """Chordal-style initialization from the FACTORS alone — the batched
    analog of the reference's (hard-disabled) SE-Sync/chordal path
    (pose_graph.cpp:31-63): no dependence on the secondary filter's seeded
    node values, so the solve is robust to arbitrary/adversarial seeding.

    1. Rotations: the graph's only rotation-coupling factors are the odometry
       between-factors, which form a chain — so linear rotation averaging is
       EXACT and reduces to integrating the (clip-aware) expected headings
       from the anchored pose 0.
    2. Translations + landmarks: with rotations fixed, every residual is
       linear in the remaining variables; positions are dead-reckoned, each
       landmark seeds at the mean of its measurement back-projections, then a
       fixed-rotation Schur-PCG pass (fix_theta) solves the linear LS to
       convergence. Both steps are O(T) and vmap over worlds.

    Returns (poses0, lms0) for solve().
    """
    eff, _ = _odom_moments(cfg, s.odom)
    p0 = s.poses_init[0]
    dth = jnp.where(s.odom_valid, eff[:, 1], 0.0)
    th = jnp.concatenate([p0[2][None], p0[2] + jnp.cumsum(dth)])  # (T+1,)
    d_eff = jnp.where(s.odom_valid, eff[:, 0], 0.0)
    px = p0[0] + jnp.concatenate(
        [jnp.zeros(1, jnp.float32), jnp.cumsum(d_eff * jnp.cos(th[:-1]))]
    )
    py = p0[1] + jnp.concatenate(
        [jnp.zeros(1, jnp.float32), jnp.cumsum(d_eff * jnp.sin(th[:-1]))]
    )
    poses = jnp.stack([px, py, wrap_angle(th)], axis=1)

    # landmark seeds: masked mean of all back-projections through the
    # dead-reckoned trajectory (measurement at row t attaches to pose t+1)
    pt = poses[1:]
    gx = pt[:, 0:1] + s.meas_rb[..., 0] * jnp.cos(
        pt[:, 2:3] + s.meas_rb[..., 1]
    )  # (T, K)
    gy = pt[:, 1:2] + s.meas_rb[..., 0] * jnp.sin(
        pt[:, 2:3] + s.meas_rb[..., 1]
    )
    valid = s.meas_valid.astype(jnp.float32)
    n_cap = s.lms_init.shape[0]
    flat = s.meas_lm.reshape(-1)
    wsum = jnp.zeros(n_cap, jnp.float32).at[flat].add(valid.reshape(-1))
    sx = jnp.zeros(n_cap, jnp.float32).at[flat].add((gx * valid).reshape(-1))
    sy = jnp.zeros(n_cap, jnp.float32).at[flat].add((gy * valid).reshape(-1))
    lms = jnp.stack([sx, sy], axis=1) / jnp.maximum(wsum, 1.0)[:, None]

    # linear LS polish at fixed rotations (2 GN steps: the problem is linear,
    # the second step only mops up CG truncation)
    poses, lms, _ = solve_schur_pcg(
        cfg, s, poses, lms, n_gn=2,
        n_cg=max(cfg.pose_graph.bulk_cg_iters, 40), fix_theta=True,
    )
    return poses, lms


def solve(cfg: Config, s: PoseGraphState, poses0=None, lms0=None):
    """Full graph optimization (pose_graph.cpp:283-284). Returns
    (poses, lms, final_error).

    Dispatches on PoseGraphConfig.solver: "schur" (default) runs the
    O(T)-per-iteration Schur/block-Thomas PCG-GN (solve_schur_pcg — reaches
    the dense optimum: identical per-world objectives and position error to
    4 decimals at T=1000); "dense" runs the original graduated dense LM
    (solve_dense), kept as the reference implementation.
    """
    if cfg.pose_graph.solver == "dense":
        return solve_dense(cfg, s, poses0, lms0)
    pg = cfg.pose_graph
    if poses0 is None and pg.init == "chordal":
        poses0_, lms0_ = chordal_init(cfg, s)
    else:
        poses0_ = s.poses_init if poses0 is None else poses0
        lms0_ = s.lms_init if lms0 is None else lms0
    # graduated non-convexity for cold starts (same 16x/4x/1x schedule as
    # solve_dense): tight bearing sigmas — razor-sharp at the low-noise
    # profile (~1.8e-4 rad) — create contorted local minima when GN starts
    # from a drifted init; relaxing the measurement sigmas first smooths the
    # landscape. Measured: without it, low-noise one-time PGS landed at
    # 0.76 m vs 0.018 m naive; with it, at the optimum.
    stage_gn = max(8, pg.bulk_gn_iters // 3)
    poses, lms, err = poses0_, lms0_, jnp.float32(jnp.inf)
    for scale in (16.0, 4.0):
        poses, lms, err = solve_schur_pcg(
            cfg, s, poses, lms, n_gn=stage_gn, n_cg=pg.bulk_cg_iters,
            meas_scale=scale,
        )
    poses, lms, err = solve_schur_pcg(
        cfg, s, poses, lms, n_gn=pg.bulk_gn_iters, n_cg=pg.bulk_cg_iters
    )
    if poses0 is not None:
        # a warm start (iterative-mode feedback) can sit in a worse basin
        # than the raw secondary seeding; try the raw path too, keep better
        poses_r, lms_r = s.poses_init, s.lms_init
        for scale in (16.0, 4.0):
            poses_r, lms_r, _ = solve_schur_pcg(
                cfg, s, poses_r, lms_r, n_gn=stage_gn, n_cg=pg.bulk_cg_iters,
                meas_scale=scale,
            )
        poses_r, lms_r, err_r = solve_schur_pcg(
            cfg, s, poses_r, lms_r,
            n_gn=pg.bulk_gn_iters, n_cg=pg.bulk_cg_iters,
        )
        take_r = err_r < err
        poses = jnp.where(take_r, poses_r, poses)
        lms = jnp.where(take_r, lms_r, lms)
        err = jnp.minimum(err_r, err)
    return poses, lms, err


def solve_dense(cfg: Config, s: PoseGraphState, poses0=None, lms0=None):
    """Graduated dense LM (the reference implementation of the solve;
    GTSAM LevenbergMarquardt defaults: lambda0=1e-5, factor=10).

    Graduated non-convexity: the tight bearing sigmas of the honest noise
    model create wrap local minima when initialized far from the optimum, so
    the solve runs in stages with the measurement sigmas relaxed 16x/4x/1x —
    each stage warm-starting the next. O((3T+2N)^3) per LM iteration per
    world; use solver="schur" at Monte-Carlo scale.
    """
    poses0_ = s.poses_init if poses0 is None else poses0
    lms0_ = s.lms_init if lms0 is None else lms0
    # direct solve (best when the initialization is already near the optimum,
    # e.g. long low-drift runs)
    poses, lms, err = _solve_stage(cfg, s, poses0_, lms0_, 1.0)
    # graduated solve (escapes bearing-wrap local minima from far inits)
    poses_g, lms_g = poses0_, lms0_
    for scale in (16.0, 4.0, 1.0):
        poses_g, lms_g, err_g = _solve_stage(cfg, s, poses_g, lms_g, scale)
    take_g = err_g < err
    poses = jnp.where(take_g, poses_g, poses)
    lms = jnp.where(take_g, lms_g, lms)
    err = jnp.minimum(err_g, err)
    if poses0 is not None:
        # a warm start (iterative-mode feedback) can sit in a worse basin
        # than the raw secondary seeding reaches through graduation — try the
        # raw graduated path too and keep the better optimum
        poses_r, lms_r = s.poses_init, s.lms_init
        for scale in (16.0, 4.0, 1.0):
            poses_r, lms_r, err_r = _solve_stage(cfg, s, poses_r, lms_r, scale)
        take_r = err_r < err
        poses = jnp.where(take_r, poses_r, poses)
        lms = jnp.where(take_r, lms_r, lms)
        err = jnp.minimum(err_r, err)
    return poses, lms, err


def _solve_stage(cfg: Config, s: PoseGraphState, poses, lms, meas_scale):
    pg = cfg.pose_graph
    err0 = graph_error(cfg, s, poses, lms, meas_scale)
    dim = 3 * poses.shape[0] + 2 * lms.shape[0]

    def cond(carry):
        _, _, _, it, done, _ = carry
        return (it < pg.max_lm_iters) & ~done

    def body(carry):
        poses, lms, lam, it, done, err = carry
        h, g, var_active = _assemble(cfg, s, poses, lms, meas_scale)
        hd = h + lam * jnp.eye(dim, dtype=jnp.float32)
        # Jacobi (symmetric diagonal) preconditioning: the whitened normal
        # equations span ~8 orders of magnitude (odometry weights 1/sigma^2 vs
        # the weak pose-0 prior), which is marginal for fp32 Cholesky.
        dscale = jax.lax.rsqrt(jnp.maximum(jnp.diag(hd), 1e-12))
        hs = hd * dscale[:, None] * dscale[None, :]
        gs = g * dscale
        # Cholesky internals also run matmuls; pin them to full fp32.
        with jax.default_matmul_precision("highest"):
            delta = (
                jax.scipy.linalg.cho_solve(
                    jax.scipy.linalg.cho_factor(hs, lower=True), gs
                )
                * dscale
            )
        d_poses = delta[: 3 * poses.shape[0]].reshape(-1, 3)
        d_lms = delta[3 * poses.shape[0]:].reshape(-1, 2)
        poses_new = poses + d_poses
        poses_new = poses_new.at[:, 2].set(wrap_angle(poses_new[:, 2]))
        lms_new = lms + d_lms
        err_new = graph_error(cfg, s, poses_new, lms_new, meas_scale)
        accept = err_new < err
        bad = ~jnp.isfinite(err_new)
        accept = accept & ~bad
        poses = jnp.where(accept, poses_new, poses)
        lms = jnp.where(accept, lms_new, lms)
        lam = jnp.where(accept, lam / pg.lambda_factor, lam * pg.lambda_factor)
        rel = jnp.abs(err - err_new) / jnp.maximum(err, 1e-12)
        done = (accept & (rel < pg.rel_err_tol)) | (lam > 1e10)
        err = jnp.where(accept, err_new, err)
        return poses, lms, lam, it + 1, done, err

    poses, lms, _, _, _, err = jax.lax.while_loop(
        cond,
        body,
        (poses, lms, jnp.float32(pg.lambda_init), jnp.int32(0), jnp.asarray(False), err0),
    )
    return poses, lms, err


def finalize(cfg: Config, s: PoseGraphState) -> PoseGraphState:
    if cfg.pose_graph.solve_graph_every_iteration:
        # initial_estimate = result feedback (pose_graph.cpp:262-267): the
        # final solve warm-starts from the per-tick solution history.
        poses, lms, _ = solve(cfg, s, poses0=s.poses_sol, lms0=s.lms_sol)
    else:
        poses, lms, _ = solve(cfg, s)
    return s.replace(poses_sol=poses, lms_sol=lms, solved=jnp.asarray(True))


# ----------------------------------------------------------------------
# Fast bulk solver: block-coordinate GN with exact block-tridiagonal pose
# solves (the batched answer to "solve 1000+ graphs at once")
# ----------------------------------------------------------------------

def _inv3(a):
    """Closed-form 3x3 inverse via adjugate (blocks are Jacobi-scaled SPD +
    damping, so entries are O(1) and the determinant is well away from 0)."""
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    det = (
        a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
    )
    det = jnp.where(jnp.abs(det) > 1e-30, det, 1.0)
    adj = jnp.stack(
        [
            jnp.stack([c00, c10, c20], axis=-1),
            jnp.stack([c01, c11, c21], axis=-1),
            jnp.stack([c02, c12, c22], axis=-1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]


def _pose_blocks(cfg: Config, s: PoseGraphState, jac, coeffs, damping):
    """Block-tridiagonal pose part of the GN Hessian: diagonal blocks D
    (T+1, 3, 3) and coupling blocks U (T, 3, 3) between consecutive nodes
    (prior on node 0; between-factors couple t and t+1; bearing-range
    factors are unary on pose t+1). Damped and with inactive nodes pinned."""
    t_cap = s.odom.shape[0]
    ja, jb = jac["ja"], jac["jb"]
    i3 = jnp.arange(3)
    d = jnp.zeros((t_cap + 1, 3, 3), jnp.float32)
    d = d.at[0, i3, i3].add(jac["inv_pr"] ** 2)
    d = d.at[:-1].add(einsum32("tri,trj->tij", ja, ja))
    d = d.at[1:].add(einsum32("tri,trj->tij", jb, jb))
    ab, bb, cb, ar, br = coeffs  # whitened, already masked by validity
    hxx = jnp.sum(ab * ab + ar * ar, axis=1)
    hxy = jnp.sum(ab * bb + ar * br, axis=1)
    hxt = jnp.sum(ab * cb, axis=1)
    hyy = jnp.sum(bb * bb + br * br, axis=1)
    hyt = jnp.sum(bb * cb, axis=1)
    htt = jnp.sum(cb * cb, axis=1)
    meas_blk = jnp.stack(
        [
            jnp.stack([hxx, hxy, hxt], axis=-1),
            jnp.stack([hxy, hyy, hyt], axis=-1),
            jnp.stack([hxt, hyt, htt], axis=-1),
        ],
        axis=-2,
    )  # (T, 3, 3)
    d = d.at[1:].add(meas_blk)
    u = einsum32("tri,trj->tij", ja, jb)  # coupling block (t, t+1)

    active = jac["pose_active"].astype(jnp.float32)  # (T+1,)
    diag = jnp.diagonal(d, axis1=1, axis2=2)
    d = d.at[:, i3, i3].add(damping * diag + (1.0 - active[:, None]))
    return d, u, active


def _tridiag_factor(d, u):
    """Block-Thomas (block-LDL) factorization of the SPD block-tridiagonal
    system — one O(T) lax.scan. Jacobi block scaling keeps the recursion
    O(1) in fp32 (raw whitened entries reach ~1e7). Returns a reusable
    factor for repeated _tridiag_solve applies (the PCG preconditioner)."""
    dsc = jax.lax.rsqrt(jnp.maximum(jnp.diagonal(d, axis1=1, axis2=2), 1e-12))
    d_s = d * dsc[:, :, None] * dsc[:, None, :]
    u_s = u * dsc[:-1, :, None] * dsc[1:, None, :]

    def fwd(s_prev, inp):
        d_t, u_prev = inp
        l_t = dot32(u_prev.T, _inv3(s_prev))
        s_t = d_t - dot32(l_t, u_prev)
        return s_t, (s_t, l_t)

    _, (s_all, l_all) = jax.lax.scan(fwd, d_s[0], (d_s[1:], u_s))
    s_full = jnp.concatenate([d_s[None, 0], s_all], axis=0)  # (T+1, 3, 3)
    sinv = _inv3(s_full)
    return {"sinv": sinv, "l": l_all, "u": u_s, "dsc": dsc}


def _tridiag_solve(fac, rhs):
    """Solve the factored block-tridiagonal system for one (T+1, 3) rhs:
    forward substitution then back substitution, two O(T) scans."""
    g_s = rhs * fac["dsc"]

    def fwd(y_prev, inp):
        g_t, l_t = inp
        y_t = g_t - dot32(l_t, y_prev)
        return y_t, y_t

    _, y_rest = jax.lax.scan(fwd, g_s[0], (g_s[1:], fac["l"]))
    y_full = jnp.concatenate([g_s[None, 0], y_rest], axis=0)

    x_last = dot32(fac["sinv"][-1], y_full[-1])

    def bwd(x_next, inp):
        sinv_t, y_t, u_t = inp
        x_t = dot32(sinv_t, y_t - dot32(u_t, x_next))
        return x_t, x_t

    _, x_rest = jax.lax.scan(
        bwd, x_last, (fac["sinv"][:-1], y_full[:-1], fac["u"]), reverse=True
    )
    return jnp.concatenate([x_rest, x_last[None]], axis=0) * fac["dsc"]


def _pose_chain_step(cfg: Config, s: PoseGraphState, poses, lms, damping):
    """One exact GN step on the poses at fixed landmarks (block-Thomas).

    This is what cold-start Jacobi-PCG cannot do: information crosses the
    whole 1000-node stiff chain in one step instead of one node per CG
    iteration.
    """
    jac = _jacobians(cfg, s, poses, lms)
    coeffs, r_meas = _meas_coeffs(cfg, s, poses, lms, 1.0)
    gp, _ = _grad(cfg, s, jac, coeffs, r_meas)  # (T+1, 3) = -J^T r
    d, u, active = _pose_blocks(cfg, s, jac, coeffs, damping)
    fac = _tridiag_factor(d, u)
    delta = _tridiag_solve(fac, gp * active[:, None])
    return delta * active[:, None]


def _lm_hessian_inv(cfg: Config, s: PoseGraphState, jac, coeffs, damping):
    """Per-landmark 2x2 GN Hessian blocks H_ll and their inverses (landmark
    variables are mutually independent given the poses)."""
    n_cap = s.lms_init.shape[0]
    ab, bb, cb, ar, br = coeffs
    flat = s.meas_lm.reshape(-1)
    hxx = jnp.zeros(n_cap, jnp.float32).at[flat].add(
        (ab * ab + ar * ar).reshape(-1)
    )
    hxy = jnp.zeros(n_cap, jnp.float32).at[flat].add(
        (ab * bb + ar * br).reshape(-1)
    )
    hyy = jnp.zeros(n_cap, jnp.float32).at[flat].add(
        (bb * bb + br * br).reshape(-1)
    )
    active = jac["lm_active"].astype(jnp.float32)
    hxx = hxx * (1.0 + damping) + (1.0 - active) + 1e-12
    hyy = hyy * (1.0 + damping) + (1.0 - active) + 1e-12
    det = hxx * hyy - hxy * hxy
    det = jnp.where(jnp.abs(det) > 1e-30, det, 1.0)
    inv = jnp.stack([hyy / det, -hxy / det, hxx / det], axis=1)  # (N, 3)
    return inv, active


def _hll_inv_apply(hll_inv, w):
    """(N, 2) -> (N, 2): apply the per-landmark 2x2 inverse."""
    return jnp.stack(
        [
            hll_inv[:, 0] * w[:, 0] + hll_inv[:, 1] * w[:, 1],
            hll_inv[:, 1] * w[:, 0] + hll_inv[:, 2] * w[:, 1],
        ],
        axis=1,
    )


def _hpl_t_apply(s: PoseGraphState, coeffs, vp):
    """w_l = H_pl^T v_p: per measurement u = J_pose v_pose(t+1), then
    J_lm^T u scatter-added per landmark. (T, K) elementwise + one scatter."""
    ab, bb, cb, ar, br = coeffs
    vx = vp[1:, 0][:, None]
    vy = vp[1:, 1][:, None]
    vt = vp[1:, 2][:, None]
    u_b = ab * vx + bb * vy + cb * vt
    u_r = ar * vx + br * vy
    wl_x = -(ab * u_b + ar * u_r)
    wl_y = -(bb * u_b + br * u_r)
    n_cap = s.lms_init.shape[0]
    flat = s.meas_lm.reshape(-1)
    return jnp.stack(
        [
            jnp.zeros(n_cap, jnp.float32).at[flat].add(wl_x.reshape(-1)),
            jnp.zeros(n_cap, jnp.float32).at[flat].add(wl_y.reshape(-1)),
        ],
        axis=1,
    )


def _hpl_apply(s: PoseGraphState, coeffs, vl):
    """y_p = H_pl v_l: per measurement u = J_lm v_lm, then J_pose^T u
    accumulated per pose row."""
    ab, bb, cb, ar, br = coeffs
    vlg = vl[s.meas_lm]  # (T, K, 2)
    u_b = -(ab * vlg[..., 0] + bb * vlg[..., 1])
    u_r = -(ar * vlg[..., 0] + br * vlg[..., 1])
    t_cap = s.odom.shape[0]
    yp = jnp.zeros((t_cap + 1, 3), jnp.float32)
    yp = yp.at[1:].add(
        jnp.stack(
            [
                jnp.sum(ab * u_b + ar * u_r, axis=1),
                jnp.sum(bb * u_b + br * u_r, axis=1),
                jnp.sum(cb * u_b, axis=1),
            ],
            axis=-1,
        )
    )
    return yp


def solve_schur_pcg(
    cfg: Config, s: PoseGraphState, poses, lms,
    n_gn: int = 8, n_cg: int = 12, damping: float = 1e-4,
    meas_scale: float = 1.0, fix_theta: bool = False,
):
    """Bulk GN solver: eliminate landmarks by Schur complement, solve the
    reduced pose system with CG preconditioned by its EXACT block-tridiagonal
    chain part (block-Thomas, factored once per GN step, O(T) per apply).

    Why this shape: the odometry chain carries the stiff information
    (whitened weights ~1e7) and lives entirely inside the preconditioner, so
    CG only has to correct for the much softer landmark coupling (~3e4) that
    the Schur complement spreads across co-visible poses — a few iterations
    suffice where plain Jacobi-PCG needs O(T) to push information down the
    chain and block-coordinate GN zigzags (contraction ~0.97/outer measured
    at T=1000). Per GN step the cost is O(T) scans + O(T K) elementwise —
    no dense factorization — so thousands of worlds vmap in one call.
    Dense-LM parity is test-covered; used by solve() for Monte-Carlo scale.
    """
    err = graph_error(cfg, s, poses, lms, meas_scale)
    # Levenberg-style relative damping, adapted per GN iteration: far from
    # the optimum a full Gauss-Newton step overshoots the linearization and
    # the line search rejects it outright; raising the damping turns the
    # next step gradient-ish until steps start landing, exactly like the
    # dense LM's lambda schedule. The GN loop is a lax.scan so compile time
    # stays flat in n_gn.
    lam0 = jnp.float32(damping)

    def gn_body(carry, _):
        poses, lms, err, lam = carry
        jac = _jacobians(cfg, s, poses, lms, meas_scale)
        coeffs, r_meas = _meas_coeffs(cfg, s, poses, lms, meas_scale)
        if fix_theta:
            # freeze the heading variables (chordal init's linear position
            # solve): zero every theta column so H's theta block vanishes
            # (re-pinned to identity below) and delta_theta stays exactly 0
            jac = dict(
                jac,
                ja=jac["ja"].at[:, :, 2].set(0.0),
                jb=jac["jb"].at[:, :, 2].set(0.0),
            )
            ab_, bb_, cb_, ar_, br_ = coeffs
            coeffs = (ab_, bb_, jnp.zeros_like(cb_), ar_, br_)
        gp, gl = _grad(cfg, s, jac, coeffs, r_meas)
        if fix_theta:
            gp = gp.at[:, 2].set(0.0)
        d, u, p_active = _pose_blocks(cfg, s, jac, coeffs, lam)
        if fix_theta:
            d = d.at[:, 2, 2].add(1.0)
        fac = _tridiag_factor(d, u)
        hll_inv, l_active = _lm_hessian_inv(cfg, s, jac, coeffs, lam)
        gp = gp * p_active[:, None]
        gl = gl * l_active[:, None]

        def schur_mv(vp):
            # S v = (D_chain + H_meas,unary) v - H_pl H_ll^-1 H_pl^T v,
            # where the first term is exactly the preconditioner matrix
            # (minus damping consistency — both built from the same blocks)
            hv = einsum32("tij,tj->ti", d, vp)
            hv = hv.at[:-1].add(einsum32("tij,tj->ti", u, vp[1:]))
            hv = hv.at[1:].add(einsum32("tji,tj->ti", u, vp[:-1]))
            w = _hpl_t_apply(s, coeffs, vp)
            w = _hll_inv_apply(hll_inv, w)
            return hv - _hpl_apply(s, coeffs, w)

        # reduced rhs: g_p - H_pl H_ll^-1 g_l
        rhs = gp - _hpl_apply(s, coeffs, _hll_inv_apply(hll_inv, gl))

        xp = jnp.zeros_like(rhs)
        r = rhs
        z = _tridiag_solve(fac, r)
        p = z
        rz = jnp.sum(r * z)

        def cg_body(_, carry):
            xp, r, p, rz = carry
            sp = schur_mv(p)
            alpha = rz / jnp.maximum(jnp.sum(p * sp), 1e-30)
            xp = xp + alpha * p
            r = r - alpha * sp
            z = _tridiag_solve(fac, r)
            rz_new = jnp.sum(r * z)
            beta = rz_new / jnp.where(jnp.abs(rz) > 1e-30, rz, 1.0)
            p = z + beta * p
            return xp, r, p, rz_new

        xp, _, _, _ = jax.lax.fori_loop(0, n_cg, cg_body, (xp, r, p, rz))
        xp = xp * p_active[:, None]
        # landmark back-substitution
        xl = _hll_inv_apply(hll_inv, gl - _hpl_t_apply(s, coeffs, xp))
        xl = xl * l_active[:, None]

        # halving line search, accept-only-improving
        def cand(alpha):
            pn = poses + alpha * xp
            pn = pn.at[:, 2].set(wrap_angle(pn[:, 2]))
            ln = lms + alpha * xl
            return pn, ln, graph_error(cfg, s, pn, ln, meas_scale)

        p1, l1, e1 = cand(1.0)
        p2, l2, e2 = cand(0.5)
        best_half = e2 < e1
        p_new = jnp.where(best_half, p2, p1)
        l_new = jnp.where(best_half, l2, l1)
        e_new = jnp.minimum(e1, e2)
        ok = (e_new < err) & jnp.isfinite(e_new)
        poses = jnp.where(ok, p_new, poses)
        lms = jnp.where(ok, l_new, lms)
        err = jnp.where(ok, e_new, err)
        lam = jnp.where(
            ok, jnp.maximum(lam / 3.0, 1e-6), jnp.minimum(lam * 8.0, 1e4)
        )
        return (poses, lms, err, lam), None

    (poses, lms, err, _), _ = jax.lax.scan(
        gn_body, (poses, lms, err, lam0), None, length=n_gn
    )
    return poses, lms, err


def _landmark_step(cfg: Config, s: PoseGraphState, poses, lms, damping):
    """One exact GN step on the landmarks at fixed poses (independent 2x2
    solves per landmark)."""
    n_cap = s.lms_init.shape[0]
    jac = _jacobians(cfg, s, poses, lms)
    coeffs, r_meas = _meas_coeffs(cfg, s, poses, lms, 1.0)
    _, gl = _grad(cfg, s, jac, coeffs, r_meas)  # (N, 2) = -J^T r
    ab, bb, cb, ar, br = coeffs
    flat = s.meas_lm.reshape(-1)
    hxx = jnp.zeros(n_cap, jnp.float32).at[flat].add(
        (ab * ab + ar * ar).reshape(-1)
    )
    hxy = jnp.zeros(n_cap, jnp.float32).at[flat].add(
        (ab * bb + ar * br).reshape(-1)
    )
    hyy = jnp.zeros(n_cap, jnp.float32).at[flat].add(
        (bb * bb + br * br).reshape(-1)
    )
    active = jac["lm_active"].astype(jnp.float32)
    hxx = hxx * (1.0 + damping) + (1.0 - active) + 1e-12
    hyy = hyy * (1.0 + damping) + (1.0 - active) + 1e-12
    det = hxx * hyy - hxy * hxy
    det = jnp.where(jnp.abs(det) > 1e-30, det, 1.0)
    dx = (hyy * gl[:, 0] - hxy * gl[:, 1]) / det
    dy = (hxx * gl[:, 1] - hxy * gl[:, 0]) / det
    return jnp.stack([dx, dy], axis=1) * active[:, None]


def solve_alternating(
    cfg: Config, s: PoseGraphState, poses, lms,
    n_outer: int = 16, damping: float = 1e-4, momentum: float = 0.9,
):
    """Block-coordinate Gauss-Newton: alternate exact pose-chain and
    landmark GN steps, each guarded by a halving line search.

    MEASURED DEAD END, kept as the documented negative result: the strong
    pose-landmark coupling makes the alternation zigzag (contraction ~0.97
    per outer iteration at T=1000; heavy-ball momentum improves it to ~0.99
    -> ~0.97 effective but it still stalls 100x above the optimum after 400
    iterations). `solve_schur_pcg` solves the SAME subproblem structure
    jointly (landmarks Schur-eliminated, chain as preconditioner) and
    converges in ~50 GN steps — use that. Not wired into solve().
    """
    err = graph_error(cfg, s, poses, lms)

    def try_step(poses, lms, err, d_poses, d_lms):
        def cand(alpha):
            p = poses + alpha * d_poses
            p = p.at[:, 2].set(wrap_angle(p[:, 2]))
            l = lms + alpha * d_lms
            return p, l, graph_error(cfg, s, p, l)

        p1, l1, e1 = cand(1.0)
        p2, l2, e2 = cand(0.5)
        best_half = e2 < e1
        p_new = jnp.where(best_half, p2, p1)
        l_new = jnp.where(best_half, l2, l1)
        e_new = jnp.minimum(e1, e2)
        ok = (e_new < err) & jnp.isfinite(e_new)
        return (
            jnp.where(ok, p_new, poses),
            jnp.where(ok, l_new, lms),
            jnp.where(ok, e_new, err),
        )

    zero_l = jnp.zeros_like(lms)
    zero_p = jnp.zeros_like(poses)
    # Heavy-ball momentum over the outer loop: plain block-coordinate GN
    # zigzags under the strong pose-landmark coupling (contraction ~0.97 per
    # outer iteration); extrapolating along the last accepted displacement
    # accelerates it like momentum accelerates any linearly-converging
    # fixed-point iteration. The line-search gate rejects any overshoot.
    poses_prev, lms_prev = poses, lms
    for _ in range(n_outer):
        dp = _pose_chain_step(cfg, s, poses, lms, damping)
        poses, lms, err = try_step(poses, lms, err, dp, zero_l)
        dl = _landmark_step(cfg, s, poses, lms, damping)
        poses, lms, err = try_step(poses, lms, err, zero_p, dl)
        if momentum > 0.0:
            mp = poses - poses_prev
            mp = mp.at[:, 2].set(wrap_angle(mp[:, 2]))
            ml = lms - lms_prev
            poses_prev, lms_prev = poses, lms
            poses, lms, err = try_step(
                poses, lms, err, momentum * mp, momentum * ml
            )
    return poses, lms, err


# ----------------------------------------------------------------------
# Iterative mode: matrix-free PCG Gauss-Newton, re-solved every tick
# ----------------------------------------------------------------------

def solve_pcg_gn(
    cfg: Config, s: PoseGraphState, poses, lms,
    n_gn: int = 1, n_cg: int = 12, meas_scale: float = 1.0,
    damping: float = 1e-4,
):
    """Matrix-free damped Gauss-Newton with Jacobi-preconditioned CG.

    The dense solve is O((3T+2N)^3) per call; this is O(n_cg * F) with
    F = T + T*K factor slots, which makes the reference's default
    `solve_graph_every_iteration` mode (pose_graph.cpp:262-267) affordable
    on device inside the per-tick scan. With a warm start (the previous
    tick's solution) one GN step with ~a dozen CG iterations tracks the
    optimum; the final solve (`finalize`) polishes with the full LM.

    Iteration counts are static (no early exit) so the function vmaps with
    uniform cost; inactive variables are pinned via masks.
    """
    t_cap = s.odom.shape[0]
    n_cap = s.lms_init.shape[0]

    def dot(ap, al, bp, bl_):
        return jnp.sum(ap * bp) + jnp.sum(al * bl_)

    for _ in range(n_gn):
        jac = _jacobians(cfg, s, poses, lms, meas_scale)
        coeffs, r_meas = _meas_coeffs(cfg, s, poses, lms, meas_scale)
        mp = jac["pose_active"][:, None].astype(jnp.float32)
        ml = jac["lm_active"][:, None].astype(jnp.float32)
        gp, gl = _grad(cfg, s, jac, coeffs, r_meas)
        gp, gl = gp * mp, gl * ml
        dp, dl = _h_diag(s, jac, coeffs)
        # damped Jacobi preconditioner; inactive vars get unit diag
        dp = jnp.where(mp > 0, dp * (1.0 + damping) + 1e-12, 1.0)
        dl = jnp.where(ml > 0, dl * (1.0 + damping) + 1e-12, 1.0)

        def hv(vp, vl):
            op, ol = _hv(s, jac, coeffs, vp * mp, vl * ml)
            # Levenberg damping keeps the warm-started step conservative
            op = (op + damping * dp * vp) * mp
            ol = (ol + damping * dl * vl) * ml
            return op, ol

        # PCG on H delta = g, delta0 = 0
        xp = jnp.zeros_like(gp)
        xl = jnp.zeros_like(gl)
        rp, rl = gp, gl
        zp, zl = rp / dp, rl / dl
        pp, pl = zp, zl
        rz = dot(rp, rl, zp, zl)

        def cg_body(i, carry):
            xp, xl, rp, rl, pp, pl, rz = carry
            hp_, hl_ = hv(pp, pl)
            denom = dot(pp, pl, hp_, hl_)
            alpha = rz / jnp.where(jnp.abs(denom) > 1e-20, denom, 1.0)
            alpha = jnp.where(denom > 0, alpha, 0.0)  # H PSD guard
            xp = xp + alpha * pp
            xl = xl + alpha * pl
            rp = rp - alpha * hp_
            rl = rl - alpha * hl_
            zp, zl = rp / dp, rl / dl
            rz_new = dot(rp, rl, zp, zl)
            beta = rz_new / jnp.where(jnp.abs(rz) > 1e-20, rz, 1.0)
            pp = zp + beta * pp
            pl = zl + beta * pl
            return xp, xl, rp, rl, pp, pl, rz_new

        xp, xl, *_ = jax.lax.fori_loop(
            0, n_cg, cg_body, (xp, xl, rp, rl, pp, pl, rz)
        )
        # accept only improving steps (warm starts are usually near-optimal,
        # so a rejected step just keeps the previous solution)
        err_old = graph_error(cfg, s, poses, lms, meas_scale)
        poses_new = poses + xp
        poses_new = poses_new.at[:, 2].set(wrap_angle(poses_new[:, 2]))
        lms_new = lms + xl
        err_new = graph_error(cfg, s, poses_new, lms_new, meas_scale)
        ok = (err_new < err_old) & jnp.isfinite(err_new)
        poses = jnp.where(ok, poses_new, poses)
        lms = jnp.where(ok, lms_new, lms)
    return poses, lms


def replay_iterative(
    cfg: Config, s: PoseGraphState, ticks, poses_sol, lms_sol, m_at,
):
    """Re-enact the per-tick incremental solves of iterative mode
    (solve_graph_every_iteration, pose_graph.cpp:262-267) OUTSIDE the
    sim/filter loop, on a fully-assembled graph (assemble_streams).

    For each live tick t in `ticks` (traced values, static length — segment
    the full range across device calls freely): present the graph exactly as it
    stood at the end of tick t (prefix masks on odometry/measurement rows,
    timestep t+1, landmark count m_at[t]), copy the newly-added node's seed
    into the warm solution, and run the same solve_pcg_gn step the in-scan
    `solve_iteration` runs — so the replayed poses_sol/lms_sol trajectory is
    the scan path's, with the sim and secondary costs removed and the whole
    batch solving in one fused scan per time segment.

    m_at: (T,) landmark count at the END of each tick
    (m_at[t] = #{first sightings <= t}). Returns (poses_sol', lms_sol').
    """
    pg = cfg.pose_graph
    t_cap = s.odom.shape[0]
    tidx = jnp.arange(t_cap)

    def tick_body(carry, t):
        poses_sol, lms_sol = carry
        m_prev = jnp.where(t > 0, m_at[jnp.maximum(t - 1, 0)], 0)
        s_t = s.replace(
            timestep=(t + 1).astype(jnp.int32),
            M=m_at[t],
            odom_valid=s.odom_valid & (tidx <= t),
            meas_valid=s.meas_valid & (tidx <= t)[:, None],
        )
        new_row = jax.lax.dynamic_slice_in_dim(s.poses_init, t + 1, 1, axis=0)
        poses0 = jax.lax.dynamic_update_slice_in_dim(
            poses_sol, new_row, t + 1, axis=0
        )
        slot = jnp.arange(s.lms_init.shape[0])[:, None]
        lms0 = jnp.where(slot < m_prev, lms_sol, s.lms_init)
        poses_new, lms_new = solve_pcg_gn(
            cfg, s_t, poses0, lms0, n_gn=pg.gn_steps_per_tick,
            n_cg=pg.pcg_iters,
        )
        return (poses_new, lms_new), None

    (poses_sol, lms_sol), _ = jax.lax.scan(
        tick_body, (poses_sol, lms_sol), jnp.asarray(ticks, jnp.int32)
    )
    return poses_sol, lms_sol


def solve_iteration(
    cfg: Config, s: PoseGraphState, m_prev, node_t=None
) -> PoseGraphState:
    """One per-tick incremental solve (solve_graph_every_iteration=true,
    pose_graph.cpp:262-267): warm-start from the previous solution with the
    newly-added pose node (and any new landmarks) taken from the secondary
    seeds, run PCG-GN, and store the result back as the next initial
    estimate.

    node_t: the just-added node index (== s.timestep), when available
    unbatched from the scan — keeps the warm-start row copy scatter-free
    under vmap (see _set_row).
    """
    pg = cfg.pose_graph
    t = s.timestep if node_t is None else jnp.asarray(node_t, jnp.int32)
    new_row = jax.lax.dynamic_slice_in_dim(s.poses_init, t, 1, axis=0)
    poses0 = jax.lax.dynamic_update_slice_in_dim(s.poses_sol, new_row, t, axis=0)
    slot = jnp.arange(s.lms_init.shape[0])[:, None]
    lms0 = jnp.where(slot < m_prev, s.lms_sol, s.lms_init)
    poses, lms = solve_pcg_gn(
        cfg, s, poses0, lms0, n_gn=pg.gn_steps_per_tick, n_cg=pg.pcg_iters
    )
    return s.replace(poses_sol=poses, lms_sol=lms, solved=jnp.asarray(True))
