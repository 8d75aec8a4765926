"""Right-invariant EKF-SLAM (RI-EKF) on the fixed-capacity padded state.

A consistency-preserving SLAM filter the reference does not have (it goes
BEYOND /root/reference's filter set, like planning/rrt.py does for the RRT
stub): the estimation error is defined in the Lie group SE_{1+M}(2) as
eta = X Xhat^{-1} (Barrau & Bonnabel; see PAPERS.md "Exploiting Symmetries to
Design EKFs with Consistency Properties for Navigation and SLAM"). For the
reference's exact problem — unicycle odometry (sim_node.py:222) + known-id
range-bearing landmarks (sim_node.py:244-250) — this formulation collapses
the standard EKF's trig-heavy Jacobians (ekf.cpp:47-54,117-126) into algebra
that is strictly friendlier to vector hardware *and* provably preserves the
observability structure a standard EKF-SLAM violates (the classic spurious
yaw-information gain):

  * **Predict is F = I.** The right-invariant error does not propagate
    through deterministic motion, so P_pred = P + two rank-1 noise outer
    products (the w_d column and the w_a column of Ad_Xhat G); no F P F^T.
  * **H is constant.** In invariant coordinates the Cartesian innovation is
    e = Rhat y_b - (lm - p) ~= (xi_lm - xi_p) + Rhat n, so H = [-I | 0 | +I]
    independent of the state: P H^T is a 2-column gather-subtract.
  * **Insertion has no heading coupling.** eta_new = eta_p + Rhat n exactly,
    so the new landmark's covariance rows are a copy of the vehicle-position
    rows plus a fresh 2x2 noise block (vs the reference's insertion Jacobian
    Y with G_z/G_x blocks, ekf.cpp:152-172).

State layout matches models/ekf.py — x = (x, y, theta, lm...) padded to
3 + 2*N_cap with ids/M slot bookkeeping — so every consumer (publishing,
pose-graph secondary coupling, viz, metrics) works unchanged. P is indexed in
the same order but holds the RIGHT-INVARIANT error covariance: the marginal
position block coincides with the additive covariance to first order at
small heading error; covariance-consuming displays are documented
approximations.

The measurement's polar noise (diag(w00, w11) via cfg.filter_noise(), the
same V/W-swap-aware accessor every filter uses) maps to the Cartesian
innovation as Rtil = Rhat J_pc W J_pc^T Rhat^T with J_pc the polar->Cartesian
Jacobian at the measured (r, b).

Sequential per-measurement updates run as the same ascending-id
measurement-slot scan as models/ekf.py, with masked no-op slots exact
identities (exp(0) = I is exact in fp32). Known landmark ids only
(constraints.measurements.landmark_id_is_known); there is no reference
behavior to be compatible with, so no compat flags apply.
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

# Initial pose covariance (same prior as the reference filters, ekf.cpp:11-18;
# for eta ~= additive error at the identity-attitude init this is the same
# statement).
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


def _v_so2(dth):
    """SE(2) left Jacobian V(dth) entries (a, b) with
    V = [[a, -b], [b, a]], a = sin/dth, b = (1-cos)/dth; exact I at dth=0."""
    small = jnp.abs(dth) < 1e-6
    safe = jnp.where(small, 1.0, dth)
    a = jnp.where(small, 1.0 - dth * dth / 6.0, jnp.sin(safe) / safe)
    b = jnp.where(small, 0.5 * dth, (1.0 - jnp.cos(safe)) / safe)
    return a, b


def _retract(x, xi):
    """X <- exp(xi) X for SE_{1+M}(2) on the flat (x, y, th, lm...) layout.

    exp(xi) rotates every translation slot (vehicle AND landmarks) by
    R(xi_th) about the origin and adds V(xi_th) xi_slot; inactive slots hold
    exactly 0 in both x and xi, and 0 is a fixed point of the map, so no
    masking is needed. xi = 0 retracts to x bitwise (cos 0 = 1, sin 0 = 0,
    V(0) = I exactly)."""
    dth = xi[2]
    c, s = jnp.cos(dth), jnp.sin(dth)
    a, b = _v_so2(dth)
    # vehicle position (indices 0, 1)
    vx = a * xi[0] - b * xi[1] + c * x[0] - s * x[1]
    vy = b * xi[0] + a * xi[1] + s * x[0] + c * x[1]
    # landmark pairs (3+2k, 4+2k): uniform strides, static slicing
    lx, ly = x[3::2], x[4::2]
    kx, ky = xi[3::2], xi[4::2]
    nlx = a * kx - b * ky + c * lx - s * ly
    nly = b * kx + a * ky + s * lx + c * ly
    out = x.at[0].set(vx).at[1].set(vy).at[2].set(wrap_angle(x[2] + dth))
    out = out.at[3::2].set(nlx).at[4::2].set(nly)
    return out


def predict(cfg: Config, s: GaussianState, cmd):
    """Prediction: exact group motion, P + rank-1 noise terms only (F = I).

    Noise columns (invariant coords, pre-predict Xhat): the executed-distance
    unit noise maps to g_d = (cos th, sin th, 0, ...); the heading unit noise
    maps to g_a = Ad_Xhat (1, (0, -d)) = (d sin th + y, -d cos th - x, 1,
    {lm_y, -lm_x}...), with inactive landmark components masked to keep their
    rows/cols exactly zero."""
    (v00, v11), _ = cfg.filter_noise()
    v_d, v_th = cfg.process_noise.v_d, cfg.process_noise.v_th
    d_cmd, th_cmd = cmd[0], cmd[1]
    if use_calibrated(cfg):
        eff_d, eff_th, v00, v11 = motion_moments(cfg, d_cmd, th_cmd)
        jac_d = eff_d
    else:
        eff_d, eff_th = d_cmd + v_d, th_cmd + v_th
        jac_d = d_cmd
    th = s.x[2]
    c, si = jnp.cos(th), jnp.sin(th)
    dvec = s.x.shape[0]
    n_cap = (dvec - 3) // 2

    g_d = jnp.zeros(dvec, jnp.float32).at[0].set(c).at[1].set(si)
    active = (jnp.arange(n_cap) < s.M).astype(jnp.float32)
    lm_x = s.x[3::2]
    lm_y = s.x[4::2]
    g_a = jnp.zeros(dvec, jnp.float32)
    g_a = g_a.at[0].set(jac_d * si + s.x[1]).at[1].set(
        -jac_d * c - s.x[0]
    ).at[2].set(1.0)
    g_a = g_a.at[3::2].set(active * lm_y).at[4::2].set(-active * lm_x)
    p_pred = s.P + v00 * jnp.outer(g_d, g_d) + v11 * jnp.outer(g_a, g_a)

    x_pred = (
        s.x.at[0]
        .add(eff_d * c)
        .at[1]
        .add(eff_d * si)
        .at[2]
        .set(wrap_angle(th + eff_th))
    )
    return x_pred, p_pred


def _meas_slot_update(cfg: Config, carry, slot, w_diag):
    """One measurement slot: invariant landmark update or insertion."""
    x, p, ids, m = carry
    mid, r, b, valid = slot
    n_cap = ids.shape[0]
    dvec = x.shape[0]
    slot_idx = jnp.arange(n_cap)

    match = (ids == mid) & (slot_idx < m)
    found = jnp.any(match)
    i = jnp.argmax(match)

    th = x[2]
    c, si = jnp.cos(th), jnp.sin(th)
    # body-frame Cartesian measurement and its world-frame noise
    # Rtil = Rhat J_pc W J_pc^T Rhat^T
    cb, sb = jnp.cos(b), jnp.sin(b)
    y_w = jnp.stack([r * (c * cb - si * sb), r * (si * cb + c * sb)])
    jr = jnp.array(
        [[c * cb - si * sb, -r * (c * sb + si * cb)],
         [si * cb + c * sb, r * (c * cb - si * sb)]],
        jnp.float32,
    )  # Rhat @ J_pc
    rtil = dot32(jr * w_diag[None, :], jr.T)

    li = 3 + 2 * i
    e_upd = sel_cols(dvec, li)  # (D, 2) one-hot at the matched slot

    # ---------------- landmark update path ----------------
    lmx = dot32(x, e_upd)  # lm estimate (2,)
    nu = y_w - (lmx - x[:2])  # Cartesian invariant innovation
    # P H^T with constant H = [-I | 0 | +I]: matched columns minus pos columns
    ph_t = dot32(p, e_upd) - p[:, :2]  # (D, 2)
    ss = dot32(e_upd.T, ph_t) - ph_t[:2, :] + rtil  # 2x2
    det = ss[0, 0] * ss[1, 1] - ss[0, 1] * ss[1, 0]
    # same small positive floor as the fused rollout (ops/fused_rollout.py):
    # a near-singular S in fp32 must not produce an unbounded gain
    det = jnp.where(jnp.abs(det) > 1e-20, det, 1.0)
    s_inv = (
        jnp.array([[ss[1, 1], -ss[0, 1]], [-ss[1, 0], ss[0, 0]]], jnp.float32)
        / det
    )
    k = dot32(ph_t, s_inv)  # (D, 2)
    do_update = valid & found
    su = do_update.astype(jnp.float32)
    xi = su * (k[:, 0] * nu[0] + k[:, 1] * nu[1])
    x_upd = _retract(x, xi)
    # P - K (H P); (H P) = (P H^T)^T by per-tick-symmetrized P (see update())
    upd_delta = k[:, 0:1] * ph_t[None, :, 0] + k[:, 1:2] * ph_t[None, :, 1]

    # ---------------- insertion path ----------------
    li_new = 3 + 2 * m
    e_new = sel_cols(dvec, li_new)
    nm = e_new[:, 0] + e_new[:, 1]
    seed = x[:2] + y_w
    x_ins = x * (1.0 - nm) + dot32(e_new, seed)
    # eta_new = eta_p + Rhat n exactly: rows copy the vehicle-position rows,
    # the corner adds the fresh measurement noise — no heading coupling
    new_rows = p[:2, :]  # (2, D)
    new_block = p[:2, :2] + rtil
    e0, e1 = e_new[:, 0], e_new[:, 1]
    r_corner = jnp.stack([new_rows @ e0, new_rows @ e1], axis=1)
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
    ids_ins = jnp.where(slot_idx == m, mid, ids)
    can_insert = m < n_cap

    # ---------------- select (masked deltas, one pass over P) -------------
    do_insert = valid & ~found & can_insert
    sif = do_insert.astype(jnp.float32)
    ins_mask = 1.0 - off_rows[:, None] * off_rows[None, :]
    p_out = p - su * upd_delta + sif * (col_term + row_term - p * ins_mask)
    x_out = jnp.where(do_update, x_upd, jnp.where(do_insert, x_ins, x))
    ids_out = jnp.where(do_insert, ids_ins, ids)
    m_out = jnp.where(do_insert, m + 1, m)
    return (x_out, p_out, ids_out, m_out), None


def update(cfg: Config, s: GaussianState, cmd, meas: Measurements) -> GaussianState:
    """One full RI-EKF iteration: predict, then sequential per-measurement
    invariant updates in ascending-id slot order (same discipline as
    models/ekf.update)."""
    if not cfg.constraints.measurements.landmark_id_is_known:
        raise ValueError(
            "iekf_slam requires known landmark ids "
            "(constraints.measurements.landmark_id_is_known)"
        )
    _, (w00, w11) = cfg.filter_noise()
    if use_calibrated(cfg):
        w00, w11 = calibrated_meas_vars(cfg)
    w_diag = jnp.array([w00, w11], jnp.float32)
    x_pred, p_pred = predict(cfg, s, cmd)

    slots = (meas.ids, meas.r, meas.b, meas.valid)

    def body(carry, slot):
        return _meas_slot_update(cfg, carry, slot, w_diag)

    (x_t, p_t, ids, m), _ = jax.lax.scan(
        body, (x_pred, p_pred, s.ids, s.M), slots
    )
    p_t = 0.5 * (p_t + p_t.T)
    return GaussianState(
        x=x_t, P=p_t, ids=ids, M=m, timestep=s.timestep + 1
    )


def pose(s: GaussianState):
    return s.x[:3]


def state_vector(s: GaussianState):
    return s.x
