"""EKF-SLAM on a fixed-capacity padded state (a rebuild of ekf.cpp).

State layout matches the reference — (x, y, theta, lm_x1, lm_y1, ...) with
covariance P — but at a static dim D = 3 + 2*N_cap. Where the C++ grows the
state with `conservativeResize` (ekf.cpp:146), we pre-allocate N_cap landmark
slots; an insertion is a masked write at slot M whose new covariance rows/cols
fully overwrite whatever the inactive slot held, so inactive-slot garbage is
provably never read by active math.

Structure exploited instead of dense matmuls (D<=128, so these are VPU ops):
  * predict F_x = I + u e2^T  =>  F P F^T is two rank-1 updates (ekf.cpp:47-61)
  * update subtracts the rank-2 K (H P) term; H has only 5 nonzero columns
  * sequential per-measurement updates are a lax.scan over measurement slots in
    ascending-id order, the exact order of the C++ loop (ekf.cpp:73-174).

Quirk compatibility (all behind cfg.compat, see config.CompatConfig):
noise V/W swap, stale-landmark linearization, unwrapped bearing innovation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from live_ekf_slam_tpu.config import Config
from live_ekf_slam_tpu.core.noise import (
    calibrated_meas_vars,
    motion_moments,
    use_calibrated,
)
from live_ekf_slam_tpu.core.types import GaussianState, Measurements
from live_ekf_slam_tpu.ops.precision import dot32, sel_cols
from live_ekf_slam_tpu.utils.geometry import wrap_angle

# Initial pose covariance (ekf.cpp:11-18).
_P0_DIAG = (0.01 * 0.01, 0.01 * 0.01, 0.005 * 0.005)


def init(cfg: Config, init_pose=None) -> GaussianState:
    n = cfg.num_landmark_slots
    d = 3 + 2 * n
    pose = jnp.asarray(
        cfg.init_pose if init_pose is None else init_pose, jnp.float32
    )
    x = jnp.zeros(d, jnp.float32).at[:3].set(pose)
    p = jnp.zeros((d, d), jnp.float32).at[
        jnp.arange(3), jnp.arange(3)
    ].set(jnp.asarray(_P0_DIAG, jnp.float32))
    return GaussianState(
        x=x,
        P=p,
        ids=jnp.full(n, -1, jnp.int32),
        M=jnp.int32(0),
        timestep=jnp.int32(0),
    )


def predict(cfg: Config, s: GaussianState, cmd):
    """Prediction stage (ekf.cpp:41-61) via rank-1 structure.

    F_x = I + u e2^T with u = (-d sin th, d cos th, 0, ...), so
    F P F^T = P + u P[2,:] + (P + u P[2,:])[:,2] u^T.
    """
    (v00, v11), _ = cfg.filter_noise()
    v_d, v_th = cfg.process_noise.v_d, cfg.process_noise.v_th
    d_cmd, th_cmd = cmd[0], cmd[1]
    if use_calibrated(cfg):
        # clip-aware expected motion + true clipped-uniform process variance
        # (core/noise.py); eff_* already include the v_d/v_th means
        eff_d, eff_th, v00, v11 = motion_moments(cfg, d_cmd, th_cmd)
        jac_d = eff_d
    else:
        eff_d, eff_th = d_cmd + v_d, th_cmd + v_th
        jac_d = d_cmd  # F_x built from the raw command (ekf.cpp:47-50)
    th = s.x[2]
    c, si = jnp.cos(th), jnp.sin(th)
    dvec = s.x.shape[0]

    u = jnp.zeros(dvec, jnp.float32).at[0].set(-jac_d * si).at[1].set(jac_d * c)
    fp = s.P + jnp.outer(u, s.P[2, :])
    p_pred = fp + jnp.outer(fp[:, 2], u)
    # F_v V F_v^T contributes only to the top-left 3x3 (ekf.cpp:51-54).
    fv = jnp.array(
        [
            [c * c * v00, si * c * v00, 0.0],
            [si * c * v00, si * si * v00, 0.0],
            [0.0, 0.0, v11],
        ],
        jnp.float32,
    )
    p_pred = p_pred.at[:3, :3].add(fv)

    x_pred = (
        s.x.at[0]
        .add(eff_d * c)
        .at[1]
        .add(eff_d * si)
        .at[2]
        .set(wrap_angle(th + eff_th))
    )
    return x_pred, p_pred


def _meas_slot_update(cfg: Config, carry, slot, x_committed, w_diag):
    """Process one measurement slot: landmark update (ekf.cpp:110-140) or
    insertion (ekf.cpp:141-173), selected by masks."""
    x, p, ids, m = carry
    mid, r, b, valid = slot
    n_cap = ids.shape[0]
    dvec = x.shape[0]
    w_r, w_b = cfg.sensing_noise.w_r, cfg.sensing_noise.w_b
    slot_idx = jnp.arange(n_cap)

    if cfg.constraints.measurements.landmark_id_is_known:
        match = (ids == mid) & (slot_idx < m)
        found = jnp.any(match)
        i = jnp.argmax(match)
        ins_id = mid
    else:
        # Positional data association (ekf.cpp:82-98): project the detection
        # and match the first landmark within min_landmark_separation in both
        # coordinates.
        sep = cfg.constraints.measurements.min_landmark_separation
        det_x = x[0] + r * jnp.cos(x[2] + b)
        det_y = x[1] + r * jnp.sin(x[2] + b)
        lm_xs = x[3::2][:n_cap]
        lm_ys = x[4::2][:n_cap]
        match = (
            (jnp.abs(det_x - lm_xs) < sep)
            & (jnp.abs(det_y - lm_ys) < sep)
            & (slot_idx < m)
        )
        found = jnp.any(match)
        i = jnp.argmax(match)
        ins_id = m  # next available id in ascending order (ekf.cpp:84)

    li = 3 + 2 * i
    e_upd = sel_cols(dvec, li)  # (D, 2) one-hot at the matched slot

    # ---------------- landmark update path ----------------
    lm_src = x_committed if cfg.compat.ekf_stale_landmarks else x
    lmx = dot32(lm_src, e_upd)  # == lm_src[li:li+2] without a gather
    ddx = lmx[0] - x[0]
    ddy = lmx[1] - x[1]
    dist_raw = jnp.sqrt(ddx * ddx + ddy * ddy)
    safe = valid & found
    dist = jnp.where(safe & (dist_raw > 0), dist_raw, 1.0)

    h_veh = jnp.array(
        [
            [-ddx / dist, -ddy / dist, 0.0],
            [ddy / (dist * dist), -ddx / (dist * dist), -1.0],
        ],
        jnp.float32,
    )
    h_lm = jnp.array(
        [
            [ddx / dist, ddy / dist],
            [-ddy / (dist * dist), ddx / (dist * dist)],
        ],
        jnp.float32,
    )
    h = jnp.zeros((2, dvec), jnp.float32).at[:, :3].set(h_veh)
    h = h + dot32(h_lm, e_upd.T)  # h[:, li:li+2] = h_lm (li >= 3 always)

    ang = wrap_angle(jnp.arctan2(ddy, ddx) - x[2])
    nu_b = b - ang - w_b
    if not cfg.compat.ekf_unwrapped_innovation:
        nu_b = wrap_angle(nu_b)
    nu = jnp.stack([r - dist_raw - w_r, nu_b])

    # The ONLY P-sized contraction in the slot body, spelled as a
    # broadcast-multiply-reduce: exact fp32 elementwise work that fuses with
    # its neighbors (a dot_general at default precision would round through
    # reduced-precision matmul inputs for this skinny shape). Everything else
    # below is broadcasts, so the whole slot runs in a few passes over P
    # instead of materializing a (D, D) intermediate per dot_general.
    ph_t = (p[:, None, :] * h[None, :, :]).sum(-1)  # (D, 2) == P @ H^T
    ss = dot32(h, ph_t) + jnp.diag(w_diag)  # 2x2 innovation covariance
    det = ss[0, 0] * ss[1, 1] - ss[0, 1] * ss[1, 0]
    # Same 1e-20 near-singular-S floor as the fused rollout (fused_rollout.py)
    # and the IEKF, so the XLA and kernel paths agree bitwise near singular
    # innovation covariances instead of diverging on denormal dets.
    det = jnp.where(jnp.abs(det) > 1e-20, det, 1.0)
    s_inv = (
        jnp.array([[ss[1, 1], -ss[0, 1]], [-ss[1, 0], ss[0, 0]]], jnp.float32) / det
    )
    k = dot32(ph_t, s_inv)  # (D, 2)
    x_upd = x + k[:, 0] * nu[0] + k[:, 1] * nu[1]
    x_upd = x_upd.at[2].set(wrap_angle(x_upd[2]))
    # K (H P) with (H P) = (P H^T)^T: P is symmetric by construction (predict
    # is F P F^T + Q, update subtracts K S K^T-structured terms, insertion
    # writes symmetric blocks), so reusing ph_t avoids a second P-sized
    # contraction. NOTE the gain K itself still comes from P *columns*
    # (k = ph_t s_inv) — only the downdate reuses the transpose; the
    # fp32-unstable spelling (K built from HP rows) is NOT what this does. Parity vs the float64 oracle and
    # T=1000 stability are test-covered.
    upd_delta = k[:, 0:1] * ph_t[None, :, 0] + k[:, 1:2] * ph_t[None, :, 1]

    # ---------------- insertion path ----------------
    tb = x[2] + b
    ct, st = jnp.cos(tb), jnp.sin(tb)
    li_new = 3 + 2 * m
    e_new = sel_cols(dvec, li_new)  # (D, 2) one-hot at the fresh slot
    nm = e_new[:, 0] + e_new[:, 1]   # (D,) 0/1 mask of the fresh rows/cols
    seed = jnp.stack([x[0] + r * ct, x[1] + r * st])
    x_ins = x * (1.0 - nm) + dot32(e_new, seed)
    g_x = jnp.array([[1.0, 0.0, -r * st], [0.0, 1.0, r * ct]], jnp.float32)
    g_z = jnp.array([[ct, -r * st], [st, r * ct]], jnp.float32)
    new_rows = (g_x[:, :, None] * p[None, :3, :]).sum(1)  # (2, D) == G_x P[:3]
    new_block = dot32(dot32(g_x, p[:3, :3]), g_x.T) + dot32(
        g_z * w_diag[None, :], g_z.T
    )
    # Equivalent of the reference's conservativeResize + block writes
    # (P[:, li:+2] = R^T; P[li:+2, :] = R; corner = new_block) expressed as
    # masked broadcasts — no scatter under vmap, no (D, D) dot_generals:
    e0, e1 = e_new[:, 0], e_new[:, 1]
    # R with its own fresh columns replaced by new_block
    r_corner = jnp.stack([new_rows @ e0, new_rows @ e1], axis=1)  # (2, 2)
    rf0 = new_rows[0] + e0 * (new_block[0, 0] - r_corner[0, 0]) + e1 * (
        new_block[0, 1] - r_corner[0, 1]
    )
    rf1 = new_rows[1] + e0 * (new_block[1, 0] - r_corner[1, 0]) + e1 * (
        new_block[1, 1] - r_corner[1, 1]
    )
    off_rows = 1.0 - nm
    col_term = off_rows[:, None] * (
        new_rows[0][:, None] * e0[None, :] + new_rows[1][:, None] * e1[None, :]
    )
    row_term = e0[:, None] * rf0[None, :] + e1[:, None] * rf1[None, :]
    ids_ins = jnp.where(slot_idx == m, jnp.int32(ins_id), ids)
    can_insert = m < n_cap

    # ---------------- select ----------------
    # P's two mutually-exclusive outcomes are applied as masked DELTAS in one
    # arithmetic expression, so XLA emits a single fused kernel that reads P
    # once and writes P once (a nested where over materialized p_upd/p_ins
    # alternatives costs ~4 extra full passes over P per slot).
    do_update = valid & found
    do_insert = valid & ~found & can_insert
    su = do_update.astype(jnp.float32)
    si = do_insert.astype(jnp.float32)
    ins_mask = 1.0 - off_rows[:, None] * off_rows[None, :]
    p_out = p - su * upd_delta + si * (col_term + row_term - p * ins_mask)
    x_out = jnp.where(do_update, x_upd, jnp.where(do_insert, x_ins, x))
    ids_out = jnp.where(do_insert, ids_ins, ids)
    m_out = jnp.where(do_insert, m + 1, m)
    return (x_out, p_out, ids_out, m_out), None


def update(cfg: Config, s: GaussianState, cmd, meas: Measurements) -> GaussianState:
    """One full EKF iteration (ekf.cpp:37-178): predict, then sequential
    per-measurement updates in slot order."""
    _, (w00, w11) = cfg.filter_noise()
    if use_calibrated(cfg):
        w00, w11 = calibrated_meas_vars(cfg)
    w_diag = jnp.array([w00, w11], jnp.float32)
    x_pred, p_pred = predict(cfg, s, cmd)

    slots = (meas.ids, meas.r, meas.b, meas.valid)

    def body(carry, slot):
        return _meas_slot_update(cfg, carry, slot, s.x, w_diag)

    (x_t, p_t, ids, m), _ = jax.lax.scan(
        body, (x_pred, p_pred, s.ids, s.M), slots
    )
    # One symmetrization per tick: the slot downdate reuses (P H^T)^T for
    # H P (see _meas_slot_update), which is exact only for symmetric P; the
    # fp32 asymmetry it leaves behind compounds over 1000-tick rollouts into
    # divergence (measured: 35/64 worlds at T=1000 without this, 0 with).
    # One extra pass per tick instead of one per slot.
    p_t = 0.5 * (p_t + p_t.T)
    return GaussianState(x=x_t, P=p_t, ids=ids, M=m, timestep=s.timestep + 1)


def state_vector(s: GaussianState):
    """(x, y, yaw, lm...) vector handed to the pose graph
    (localization_node.cpp:127 -> getStateVector, ekf.cpp:182-185)."""
    return s.x


def pose(s: GaussianState):
    return s.x[:3]
