"""Calibrated (clip-aware) motion mode: Config.calibrated_motion.

The honest-mode refinement of core/noise.py: EKF/UKF predict uses the
clip-aware expected executed command + true clipped-uniform process variance,
and measurement noise uses the true U(-W, W) variance W^2/3 — instead of the
reference's half-width-as-variance convention (filter.h:110-117). Tests:

1. motion_moments matches Monte-Carlo moments of the simulator's actual
   clip(cmd + U(-V, V)) draw (sim_node.py:216-220 semantics).
2. the fused rollout (injected noise) matches the XLA EKF under
   calibrated_motion — same parity harness as the default mode's tests.
3. end-to-end: the calibrated EKF beats the default EKF on the reference's
   own benchmark protocol (random maps, TSP trajectories, high noise), and
   its NEES is closer to the ideal dim=2 than the wildly-overconservative
   default.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from live_ekf_slam_tpu.config import Config
from live_ekf_slam_tpu.core import noise as core_noise
from live_ekf_slam_tpu.models import ekf

from test_fused_rollout import B, _setup, xla_filter_run


def test_motion_moments_match_simulator_monte_carlo():
    """motion_moments = exact moments of the sim's clipped command draw."""
    cfg = Config()
    rng = np.random.default_rng(0)
    for d_cmd, th_cmd in [(0.1, 0.0546), (0.05, -0.02), (0.0, 0.0)]:
        u = rng.uniform(-1, 1, size=200000)
        d_exec = np.clip(
            d_cmd + cfg.process_noise.V_00 * u, 0.0,
            cfg.constraints.commands.d_max,
        )
        th_exec = np.clip(
            th_cmd + cfg.process_noise.V_11 * rng.uniform(-1, 1, 200000),
            -cfg.constraints.commands.th_max,
            cfg.constraints.commands.th_max,
        )
        eff_d, eff_th, var_d, var_th = jax.tree.map(
            np.asarray,
            core_noise.motion_moments(
                cfg, jnp.float32(d_cmd), jnp.float32(th_cmd)
            ),
        )
        assert abs(eff_d - d_exec.mean()) < 3e-4
        assert abs(eff_th - th_exec.mean()) < 3e-4
        # var floored at (0.1 * v/sqrt(3))^2 — only binds at full saturation
        assert var_d >= d_exec.var() * 0.98 - 1e-9
        assert abs(var_d - d_exec.var()) < max(3e-6, 0.02 * d_exec.var()) \
            or var_d == pytest.approx(
                (0.1 * cfg.process_noise.V_00 / 3 ** 0.5) ** 2)
        assert abs(var_th - th_exec.var()) < max(3e-7, 0.02 * th_exec.var())


def test_fused_ekf_calibrated_matches_xla(rollout):
    """The fused rollout (reference everywhere, kernel on a GPU) against the
    XLA EKF driven by the same replayed sim, under calibrated_motion."""
    cfg, lms, cmds, noise = _setup()
    cfg = cfg.replace(calibrated_motion=True)
    out = rollout(cfg, jnp.asarray(lms), jnp.asarray(cmds), jnp.asarray(noise))
    xs = np.asarray(out["x"])
    errs = np.asarray(out["err_sum"])
    seen = np.asarray(out["seen"])
    for w in range(B):
        s, pose, err_sum = xla_filter_run(cfg, ekf, lms[w], cmds[w], noise[w])
        assert abs(errs[w] - err_sum) < 2e-3 * max(err_sum, 1.0)
        sx = np.asarray(s.x)
        np.testing.assert_allclose(xs[w][:3], sx[:3], atol=5e-4)
        ids = np.asarray(s.ids)[: int(s.M)]
        assert set(ids.tolist()) == set(np.where(seen[w])[0].tolist())
        for k, mid in enumerate(ids.tolist()):
            np.testing.assert_allclose(
                xs[w][3 + 2 * mid: 5 + 2 * mid],
                sx[3 + 2 * k: 5 + 2 * k],
                atol=5e-4,
            )


def test_calibrated_ekf_beats_default_at_reference_protocol():
    """End-to-end on the reference benchmark protocol (random 20-landmark
    maps, TSP trajectories whose commands saturate the clip much of the
    time): the clip-aware calibrated filter should cut the error."""
    from live_ekf_slam_tpu.eval.runner import run_monte_carlo

    batch, t_iter = 16, 250
    base = Config(num_iterations=t_iter)
    errs = {}
    for name, cfg in [
        ("default", base),
        ("calibrated", base.replace(calibrated_motion=True)),
    ]:
        res, _, _ = run_monte_carlo(
            cfg, jax.random.PRNGKey(7), batch, seed=7, collect="sums"
        )
        errs[name] = float(np.mean(res["err_ekf_slam"]))
    # the clip-aware prediction removes the forward bias on saturated ticks
    # and the honest R stops over-trusting the prediction; require a real win
    assert errs["calibrated"] < errs["default"], errs
