"""Noise-moment helpers shared by the filters and the pose graph.

The simulator draws uniform noise U(-V, V) on commands and clips the result
(sim_node.py:216-220), and draws unclipped U(-W, W) on measurements
(sim_node.py:246-249). The reference filters plug the half-widths V/W in
directly as variances (filter.h:110-117) — a ~3x-in-std mis-calibration on
measurements and worse on saturated commands. These helpers provide the TRUE
moments; `Config.calibrated_motion` routes the EKF/UKF (XLA paths and the
fused rollout) through them, mirroring the bias/variance correction
the pose graph's honest mode already gets from `_odom_moments`
(models/posegraph.py).
"""

from __future__ import annotations

import jax.numpy as jnp

from live_ekf_slam_tpu.config import Config


def clip_uniform_moments(c, v, lo, hi):
    """Mean and std of clip(c + u, lo, hi) with u ~ U(-v, v), elementwise.

    Exact truncated-uniform moments (validated against Monte Carlo to 4
    decimals), computed on the CENTERED variable g = clip(u, l, h) with
    l = clip(lo - c, -v, v), h = clip(hi - c, -v, v) — so clip(c+u, lo, hi)
    = c + g. Centering matters in fp32: E[f^2] - E[f]^2 on the uncentered
    variable cancels ~mean^2/var >> 1 digits and made the whitened Jacobians
    jit-order-sensitive at the 1e-3 level; the centered form keeps every
    term at O(v).
      P(u<l) = (l+v)/2v,  P(u>h) = (v-h)/2v
      E[g]   = P(u<l) l + P(u>h) h + (h^2 - l^2) / 4v
      E[g^2] = P(u<l) l^2 + P(u>h) h^2 + (h^3 - l^3) / 6v.
    """
    l = jnp.clip(lo - c, -v, v)
    h = jnp.clip(hi - c, -v, v)
    p_lo = (l + v) / (2.0 * v)
    p_hi = (v - h) / (2.0 * v)
    mean_g = p_lo * l + p_hi * h + (h * h - l * l) / (4.0 * v)
    m2_g = p_lo * l * l + p_hi * h * h + (h ** 3 - l ** 3) / (6.0 * v)
    var = jnp.maximum(m2_g - mean_g * mean_g, 0.0)
    return c + mean_g, jnp.sqrt(var)


def motion_moments(cfg: Config, d_cmd, th_cmd):
    """Clip-aware per-tick executed-motion moments for the EKF/UKF predict.

    Returns (eff_d, eff_th, var_d, var_th): the expected executed forward /
    heading command under the simulator's clip (biased toward the interior
    on the TSP trajectory's saturated ticks) and the true residual variances
    (<= V^2/3; std floored at 10% of the unclipped std so a fully-saturated
    tick keeps a nonzero process noise, matching _odom_moments).

    Shapes follow d_cmd/th_cmd (scalars in the XLA filters, (1, BL) lanes in
    the fused kernels).
    """
    v_fwd = cfg.process_noise.V_00
    v_hdg = cfg.process_noise.V_11
    s3 = 3.0 ** 0.5
    c_d = d_cmd + cfg.process_noise.v_d
    c_th = th_cmd + cfg.process_noise.v_th
    if v_fwd > 0.0:
        eff_d, sig_d = clip_uniform_moments(
            c_d, v_fwd, 0.0, cfg.constraints.commands.d_max
        )
        sig_d = jnp.maximum(sig_d, 0.1 * v_fwd / s3)
    else:
        eff_d, sig_d = c_d, jnp.full_like(jnp.asarray(c_d), 1e-6)
    th_max = cfg.constraints.commands.th_max
    if v_hdg > 0.0:
        eff_th, sig_th = clip_uniform_moments(c_th, v_hdg, -th_max, th_max)
        sig_th = jnp.maximum(sig_th, 0.1 * v_hdg / s3)
    else:
        eff_th, sig_th = c_th, jnp.full_like(jnp.asarray(c_th), 1e-6)
    return eff_d, eff_th, sig_d * sig_d, sig_th * sig_th


def calibrated_meas_vars(cfg: Config) -> tuple[float, float]:
    """True (range, bearing) measurement variances of U(-W, W): W^2/3.

    Python floats (W is static config), usable as kernel parameters.
    """
    return (
        cfg.sensing_noise.W_00 ** 2 / 3.0,
        cfg.sensing_noise.W_11 ** 2 / 3.0,
    )


def use_calibrated(cfg: Config) -> bool:
    """Calibrated motion applies only in honest mode — the compat V/W swap
    quirk reproduces the reference bug-for-bug and takes precedence."""
    return cfg.calibrated_motion and not cfg.compat.noise_vw_swap
