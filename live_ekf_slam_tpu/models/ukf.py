"""UKF localization & SLAM on a fixed-capacity padded state (rebuild of ukf.cpp).

State is (x, y, cos th, sin th, lm_x1, lm_y1, ...) of static dim Du = 4+2*N_cap
(the reference grows 4+2M, ukf.cpp:33,167-180). The padding trick: inactive
rows/cols of P are held at exactly zero, the sigma-point set is allocated at
full capacity (2*Du+1 columns), and the weights of columns belonging to
inactive directions are zero. Because a zero-weight column contributes nothing
to any weighted mean/covariance sum and the zero inactive block of P yields
zero sigma offsets on active dims, every active-subspace quantity equals the
reference's dynamically-sized computation exactly (the spectral clamp is a
basis-independent matrix function, so the padded `nearestSPD` restricted to the
active block equals the reference's).

Sigma-point machinery (ukf.cpp:106-123, 197-241): scaled spectral-clamped
covariance, symmetric matrix sqrt, 2n+1 points, W_0 mean weight.

Quirks behind cfg.compat: zero bearing mean (ukf.cpp:310-314), committed-state
yaw inside the sensing model (ukf.cpp:139), noise V/W swap.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from live_ekf_slam_tpu.config import Config
from live_ekf_slam_tpu.core.noise import (
    calibrated_meas_vars,
    motion_moments,
    use_calibrated,
)
from live_ekf_slam_tpu.core.types import Measurements, UKFState
from live_ekf_slam_tpu.ops.precision import dot32, sel_cols
from live_ekf_slam_tpu.utils.geometry import wrap_angle

# Initial covariance diag (ukf.cpp:9-18).
_P0_DIAG = (0.01 * 0.01, 0.01 * 0.01, 0.005 * 0.005, 0.005 * 0.005)


def state_dim(cfg: Config, slam: bool) -> int:
    return 4 + 2 * cfg.num_landmark_slots if slam else 4


def init(cfg: Config, slam: bool, init_pose=None) -> UKFState:
    du = state_dim(cfg, slam)
    n_cap = cfg.num_landmark_slots if slam else 0
    pose = jnp.asarray(
        cfg.init_pose if init_pose is None else init_pose, jnp.float32
    )
    x = (
        jnp.zeros(du, jnp.float32)
        .at[0].set(pose[0])
        .at[1].set(pose[1])
        .at[2].set(jnp.cos(pose[2]))
        .at[3].set(jnp.sin(pose[2]))
    )
    p = jnp.zeros((du, du), jnp.float32).at[
        jnp.arange(4), jnp.arange(4)
    ].set(jnp.asarray(_P0_DIAG, jnp.float32))
    return UKFState(
        x=x,
        P=p,
        ids=jnp.full(max(n_cap, 1), -1, jnp.int32),
        M=jnp.int32(0),
        timestep=jnp.int32(0),
        X=jnp.zeros((du, 2 * du + 1), jnp.float32),
    )


def _weights(cfg: Config, du: int, n_active):
    """Sigma weights: W_0 on the mean, (1-W_0)/(2n) on the 2n active columns,
    exactly 0 on padded columns (ukf.cpp:173-176)."""
    w0 = cfg.ukf.W_0
    cols = jnp.arange(2 * du + 1)
    j = (cols - 1) % du  # sqtP column index for each +/- sigma column
    active_col = (cols > 0) & (j < n_active)
    w_rest = (1.0 - w0) / (2.0 * n_active.astype(jnp.float32))
    w = jnp.where(active_col, w_rest, 0.0).at[0].set(w0)
    return w


def _sqrt_spd_clamped(p_sym_scaled):
    """nearestSPD + matrix sqrt (ukf.cpp:106-123, 207-211): clamp eigenvalues
    of the scaled symmetric matrix at 1e-8, return the principal sqrt."""
    evals, evecs = jnp.linalg.eigh(p_sym_scaled)
    evals = jnp.sqrt(jnp.maximum(evals, 1e-8))
    return dot32(evecs * evals[None, :], evecs.T)


def chol_clamped(p_sym_scaled, eps=1e-8, n_active=None):
    """Pivot-clamped Cholesky — the sigma-point sqrt a fused UKF kernel
    uses (UKFConfig.sigma_sqrt="chol"). Outer-product form; a pivot below eps is
    clamped and its column below zeroed. For PSD P this is benign (Schur:
    tiny pivot implies a tiny column, so nothing real is lost); for the
    genuinely indefinite P the reference's signed process noise produces
    (ukf.cpp:183-186), the chol mode pairs this with the Joseph-form
    measurement update, which keeps P PSD by construction so the clamp only
    ever sees fp-noise-level negatives. (A Gill–Murray pivot raise was tried
    instead of zeroing: bounding columns at beta=100 produced 100 m sigma
    offsets in the indefinite regime and diverged far worse.) Written as a
    lax.scan of full-width masked rank-1 updates."""
    du = p_sym_scaled.shape[0]
    idx = jnp.arange(du)
    n_act = du if n_active is None else n_active

    def body(carry, j):
        a, bad = carry
        pivot = a[j, j]
        ok = pivot > eps
        bad = bad | (~ok & (j < n_act))  # clamped an ACTIVE direction
        d = jnp.sqrt(jnp.maximum(pivot, eps))
        below = jnp.where((idx > j) & ok, a[:, j], 0.0) / d
        a = a - below[:, None] * below[None, :]
        a = a.at[:, j].set(below + jnp.where(idx == j, d, 0.0))
        return (a, bad), None

    (a, bad), _ = jax.lax.scan(
        body, (p_sym_scaled, jnp.bool_(False)), jnp.arange(du)
    )
    return jnp.where(idx[:, None] >= idx[None, :], a, 0.0), bad


def _yaw_of(x):
    return wrap_angle(jnp.arctan2(x[3], x[2]))


def _motion_model(cfg: Config, xcol, eff_d, eff_th):
    """ukf.cpp:125-135 applied to one sigma column (vectorized via vmap).
    eff_d/eff_th are the effective executed-motion means (command + noise
    mean, or the clip-aware expectation under calibrated_motion)."""
    yaw = wrap_angle(jnp.arctan2(xcol[3], xcol[2]))
    new_yaw = wrap_angle(yaw + eff_th)
    return (
        xcol.at[0].add(eff_d * jnp.cos(yaw))
        .at[1].add(eff_d * jnp.sin(yaw))
        .at[2].set(jnp.cos(new_yaw))
        .at[3].set(jnp.sin(new_yaw))
    )


def predict(cfg: Config, s: UKFState, cmd, slam: bool):
    """Prediction stage (ukf.cpp:197-241). Returns (x_pred, P_pred, X, Wts)."""
    (v00, v11), _ = cfg.filter_noise()
    v_d, v_th = cfg.process_noise.v_d, cfg.process_noise.v_th
    if use_calibrated(cfg):
        # clip-aware executed-motion moments (core/noise.py)
        eff_d, eff_th, v00, v11 = motion_moments(cfg, cmd[0], cmd[1])
    else:
        eff_d, eff_th = cmd[0] + v_d, cmd[1] + v_th
    du = s.x.shape[0]
    n_active = 4 + 2 * s.M if slam else jnp.int32(4)

    yaw = _yaw_of(s.x)
    c, si = jnp.cos(yaw), jnp.sin(yaw)
    q = jnp.zeros((du, du), jnp.float32)
    if cfg.compat.ukf_signed_process_noise:
        # reference quirk (ukf.cpp:182-186): SIGNED diag — negative for half
        # of all headings; the next tick's spectral clamp repairs P.
        q = q.at[jnp.arange(4), jnp.arange(4)].set(
            jnp.stack([v00 * c, v00 * si, v11 * c, v11 * si])
        )
    else:
        # correct PSD projection Q = G V G^T for the (x, y, cos, sin) state:
        # dx=c*vd, dy=s*vd, dcos=-s*vth, dsin=c*vth.
        q = (
            q.at[0, 0].set(v00 * c * c)
            .at[0, 1].set(v00 * c * si)
            .at[1, 0].set(v00 * c * si)
            .at[1, 1].set(v00 * si * si)
            .at[2, 2].set(v11 * si * si)
            .at[2, 3].set(-v11 * c * si)
            .at[3, 2].set(-v11 * c * si)
            .at[3, 3].set(v11 * c * c)
        )

    w0 = cfg.ukf.W_0
    scale = n_active.astype(jnp.float32) / (1.0 - w0)
    p_sym = 0.5 * (s.P + s.P.T) * scale
    if cfg.ukf.sigma_sqrt == "chol":
        sqt_p, _ = chol_clamped(p_sym, n_active=n_active)
    else:
        sqt_p = _sqrt_spd_clamped(p_sym)

    # sigma points: [x, x + cols(sqtP), x - cols(sqtP)] (ukf.cpp:213-219)
    xs = s.x[:, None]
    x_sig = jnp.concatenate([xs, xs + sqt_p, xs - sqt_p], axis=1)  # (Du, 2Du+1)

    x_pred_sig = jax.vmap(
        partial(_motion_model, cfg), in_axes=(1, None, None), out_axes=1
    )(x_sig, eff_d, eff_th)

    wts = _weights(cfg, du, n_active)
    x_pred = dot32(x_pred_sig, wts)
    dev = x_pred_sig - x_pred[:, None]
    p_pred = dot32(dev * wts[None, :], dev.T) + q
    return x_pred, p_pred, x_sig, x_pred_sig, wts


def _sensing(cfg: Config, xcol, lm_pos, committed_yaw):
    """Expected (r, b) for one sigma column (ukf.cpp:137-159)."""
    w_r, w_b = cfg.sensing_noise.w_r, cfg.sensing_noise.w_b
    if cfg.compat.ukf_committed_yaw_in_sensing:
        yaw = committed_yaw
    else:
        yaw = wrap_angle(jnp.arctan2(xcol[3], xcol[2]))
    dx = lm_pos[0] - xcol[0]
    dy = lm_pos[1] - xcol[1]
    r = jnp.sqrt(dx * dx + dy * dy) + w_r
    b = wrap_angle(jnp.arctan2(dy, dx) - yaw + w_b)
    return jnp.stack([r, b])


def _landmark_update(cfg, carry, r, b, li, wts, committed_yaw, true_map, w_diag, gate):
    """UKF landmark update (ukf.cpp:293-349) on the padded state.

    li: state index of the landmark's x coordinate (slam) — or, when true_map
    is given (loc mode), li is the landmark id into the true map.
    """
    x_pred, p_pred, x_pred_sig = carry

    if true_map is None:
        # rows (li, li+1) of the sigma matrix without a batched gather
        e = sel_cols(x_pred_sig.shape[0], li)
        lm_pos_cols = dot32(e.T, x_pred_sig)
    else:
        # known map, localization-only (ukf.cpp:146-153); one-hot avoids a
        # per-world gather under vmap
        onehot = (jnp.arange(true_map.shape[0]) == li).astype(jnp.float32)
        lm = dot32(onehot, true_map)
        lm_pos_cols = jnp.broadcast_to(lm[:, None], (2, x_pred_sig.shape[1]))

    z_cols = jax.vmap(
        lambda xc, lmc: _sensing(cfg, xc, lmc, committed_yaw),
        in_axes=(1, 1),
        out_axes=1,
    )(x_pred_sig, lm_pos_cols)  # (2, 2Du+1)

    if cfg.compat.ukf_zero_bearing_mean:
        # only the range mean is accumulated; bearing mean stays 0
        z_est = jnp.stack([dot32(z_cols[0], wts), jnp.float32(0.0)])
    else:
        # circular mean for the bearing component
        z_r = dot32(z_cols[0], wts)
        z_b = jnp.arctan2(dot32(jnp.sin(z_cols[1]), wts), dot32(jnp.cos(z_cols[1]), wts))
        z_est = jnp.stack([z_r, z_b])

    diff = z_cols - z_est[:, None]
    diff = diff.at[1, :].set(wrap_angle(diff[1, :]))
    ss = dot32(diff * wts[None, :], diff.T) + jnp.diag(w_diag)  # (2,2)

    dev_x = x_pred_sig - x_pred[:, None]
    c = dot32(dev_x * wts[None, :], diff.T)  # (Du, 2)

    det_raw = ss[0, 0] * ss[1, 1] - ss[0, 1] * ss[1, 0]
    # the sanity gate below must see the RAW determinant — replacing an
    # exactly-singular det with the 1.0 division sentinel before the gate
    # would let an unscaled garbage gain through in the one case the guard
    # exists for
    det = jnp.where(jnp.abs(det_raw) > 0, det_raw, 1.0)
    s_inv = jnp.array([[ss[1, 1], -ss[0, 1]], [-ss[1, 0], ss[0, 0]]], jnp.float32) / det
    k = dot32(c, s_inv)  # (Du, 2)

    innov = jnp.stack([r, b]) - z_est
    innov = innov.at[1].set(wrap_angle(innov[1]))
    if cfg.ukf.sigma_sqrt == "chol":
        # divergence guard (the role of the reference's try/catch,
        # ukf.cpp:207-211, and of SURVEY §5's per-world validity masks):
        # reject an update whose innovation or innovation covariance is
        # inconsistent — a diverged world then coasts on prediction instead
        # of spiraling to NaN and poisoning batch statistics.
        r_gate = 2.0 * cfg.constraints.vision.range_max
        # scale-aware determinant floor: calibrated-mode R is ~300x smaller
        # in variance, so a fixed 1e-12 would reject legitimate updates;
        # keep the historical floor whenever it is the smaller of the two
        det_gate = jnp.minimum(
            jnp.float32(1e-12), jnp.float32(1e-6) * w_diag[0] * w_diag[1]
        )
        sane = (
            (jnp.abs(innov[0]) < r_gate)
            & (det_raw > det_gate)
            & (ss[0, 0] > 0.0)
            & (ss[1, 1] > 0.0)
            & jnp.isfinite(innov[0])
        )
        gate = gate & sane
    x_new = x_pred + dot32(k, innov)
    if cfg.ukf.sigma_sqrt == "chol":
        # Joseph form: P - K C^T - C K^T + K S K^T. Equal to P - K S K^T for
        # the exact gain, but PSD for ANY gain given the PSD joint sigma
        # covariance [[P, C], [C^T, S]] — which keeps the chol-mode pivot
        # clamp in the benign fp-noise regime (see chol_clamped).
        p_new = (
            p_pred
            - dot32(k, c.T)
            - dot32(c, k.T)
            + dot32(dot32(k, ss), k.T)
        )
    else:
        p_new = p_pred - dot32(dot32(k, ss), k.T)

    x_out = jnp.where(gate, x_new, x_pred)
    p_out = jnp.where(gate, p_new, p_pred)
    return (x_out, p_out, x_pred_sig)


def update(
    cfg: Config,
    s: UKFState,
    cmd,
    meas: Measurements,
    slam: bool,
    true_map=None,
) -> UKFState:
    """One full UKF iteration (ukf.cpp:161-195): predict, all landmark
    *updates* first, then all *insertions* (ukf.cpp:251-287)."""
    _, (w00, w11) = cfg.filter_noise()
    if use_calibrated(cfg):
        w00, w11 = calibrated_meas_vars(cfg)
    w_diag = jnp.array([w00, w11], jnp.float32)
    du = s.x.shape[0]
    n_cap = s.ids.shape[0]
    committed_yaw = _yaw_of(s.x)

    x_pred, p_pred, x_sig, x_pred_sig, wts = predict(cfg, s, cmd, slam)

    slot_idx = jnp.arange(n_cap)

    # ---- pass 1: updates of known landmarks (or all, in loc mode) ----
    def upd_body(carry, slot):
        mid, r, b, valid = slot
        if slam:
            match = (s.ids == mid) & (slot_idx < s.M)
            found = jnp.any(match)
            li = 4 + 2 * jnp.argmax(match)
            gate = valid & found
            x_p, p_p, xs = _landmark_update(
                cfg, carry, r, b, li, wts, committed_yaw, None, w_diag, gate
            )
        else:
            li = jnp.maximum(mid, 0)
            gate = valid
            x_p, p_p, xs = _landmark_update(
                cfg, carry, r, b, li, wts, committed_yaw, true_map, w_diag, gate
            )
        return (x_p, p_p, xs), None

    slots = (meas.ids, meas.r, meas.b, meas.valid)
    (x_pred, p_pred, _), _ = jax.lax.scan(
        upd_body, (x_pred, p_pred, x_pred_sig), slots
    )

    # ---- pass 2: insertions of new landmarks (slam only) ----
    ids, m = s.ids, s.M
    if slam:
        def ins_body(carry, slot):
            x_p, p_p, ids_c, m_c = carry
            mid, r, b, valid = slot
            match = (ids_c == mid) & (slot_idx < m_c)
            is_new = valid & ~jnp.any(match) & (m_c < n_cap)
            yaw = wrap_angle(jnp.arctan2(x_p[3], x_p[2]))  # ukf.cpp:356
            li = 4 + 2 * m_c
            seed = jnp.stack(
                [x_p[0] + r * jnp.cos(yaw + b), x_p[1] + r * jnp.sin(yaw + b)]
            )
            e = sel_cols(x_p.shape[0], li)  # (Du, 2) one-hot at the new slot
            nmask = e[:, 0] + e[:, 1]
            x_ins = x_p * (1.0 - nmask) + dot32(e, seed)
            # covariance gets a fresh W block, zero cross terms (ukf.cpp:363-368)
            corner = dot32(dot32(e.T, p_p), e)
            p_ins = p_p + dot32(e, dot32(jnp.diag(w_diag) - corner, e.T))
            x_o = jnp.where(is_new, x_ins, x_p)
            p_o = jnp.where(is_new, p_ins, p_p)
            ids_o = jnp.where(
                is_new & (slot_idx == m_c), mid, ids_c
            )
            m_o = jnp.where(is_new, m_c + 1, m_c)
            return (x_o, p_o, ids_o, m_o), None

        (x_pred, p_pred, ids, m), _ = jax.lax.scan(
            ins_body, (x_pred, p_pred, s.ids, s.M), slots
        )

    return UKFState(
        x=x_pred, P=p_pred, ids=ids, M=m, timestep=s.timestep + 1, X=x_sig
    )


def pose(s: UKFState):
    return jnp.stack([s.x[0], s.x[1], _yaw_of(s.x)])


def state_vector(cfg: Config, s: UKFState, slam: bool):
    """(x, y, yaw, lm...) EKF-format vector (ukf.cpp:47-53)."""
    if not slam:
        return pose(s)
    return jnp.concatenate([pose(s), s.x[4:]])
