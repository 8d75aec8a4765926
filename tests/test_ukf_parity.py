"""Golden parity: padded fixed-capacity UKF vs the reference-equation oracle."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from live_ekf_slam_tpu.config import CompatConfig, Config
from live_ekf_slam_tpu.core.types import Measurements
from live_ekf_slam_tpu.models import ukf

from oracle import UKFOracle
from test_ekf_parity import _random_script, _to_slots

N_CAP = 4


def _cfg(compat=True):
    cfg = Config(num_iterations=40).replace(
        num_landmark_slots=N_CAP, num_meas_slots=N_CAP
    )
    if compat:
        cfg = cfg.replace(compat=CompatConfig.all_on())
    return cfg


def _oracle(cfg, slam=True, true_map=None):
    (v00, v11), (w00, w11) = cfg.filter_noise()
    return UKFOracle(
        0.0, 0.0, 0.0,
        V=(v00, v11), W=(w00, w11),
        W_0=cfg.ukf.W_0,
        slam=slam,
        true_map=true_map,
        zero_bearing_mean=cfg.compat.ukf_zero_bearing_mean,
        committed_yaw=cfg.compat.ukf_committed_yaw_in_sensing,
        signed_q=cfg.compat.ukf_signed_process_noise,
    )


@pytest.mark.parametrize("compat", [True, False])
def test_ukf_slam_trajectory_parity(compat):
    rng = np.random.default_rng(21 if compat else 22)
    cfg = _cfg(compat=compat)
    oracle = _oracle(cfg, slam=True)
    s = ukf.init(cfg, slam=True)
    upd = jax.jit(
        lambda s, cmd, meas: ukf.update(cfg, s, cmd, meas, slam=True)
    )
    script = _random_script(rng, n_ticks=25, n_lms=N_CAP)
    for cmd, meas in script:
        oracle.update(cmd, meas)
        s = upd(s, jnp.asarray(cmd, jnp.float32), _to_slots(meas, N_CAP))
    m = int(s.M)
    assert m == oracle.M
    assert [int(i) for i in np.asarray(s.ids)[:m]] == oracle.lm_ids
    n_active = 4 + 2 * m
    np.testing.assert_allclose(
        np.asarray(s.x)[:n_active], oracle.x_t, atol=5e-3
    )
    np.testing.assert_allclose(
        np.asarray(s.P)[:n_active, :n_active], oracle.P_t, atol=5e-3
    )
    # padded dims stay exactly inert
    assert np.abs(np.asarray(s.x)[n_active:]).max(initial=0.0) == 0.0
    assert np.abs(np.asarray(s.P)[n_active:, :]).max(initial=0.0) == 0.0


def test_ukf_slam_long_horizon_parity():
    """T=200 / N_CAP=20 vs the float64 oracle: catches
    slow-accumulating sigma-point drift (sqrt-cov regeneration, nearestSPD
    clamping, insertion ordering at full capacity) that the 25-tick test
    above cannot. Asserts bounded x/P drift AND exact padded-slot inertness
    with the state grown to many landmarks. Reference semantics:
    ukf.cpp:293-372 (update-before-insert, per-landmark sequential)."""
    rng = np.random.default_rng(41)
    n_cap = 20
    cfg = Config(num_iterations=220).replace(
        num_landmark_slots=n_cap, num_meas_slots=n_cap,
        compat=CompatConfig.all_on(),
    )
    oracle = _oracle(cfg, slam=True)
    s = ukf.init(cfg, slam=True)
    upd = jax.jit(
        lambda s, cmd, meas: ukf.update(cfg, s, cmd, meas, slam=True)
    )
    script = _random_script(rng, n_ticks=200, n_lms=n_cap)
    for cmd, meas in script:
        oracle.update(cmd, meas)
        s = upd(s, jnp.asarray(cmd, jnp.float32), _to_slots(meas, n_cap))
    m = int(s.M)
    assert m == oracle.M and m >= 8, f"script only inserted {m} landmarks"
    assert [int(i) for i in np.asarray(s.ids)[:m]] == oracle.lm_ids
    n_active = 4 + 2 * m
    # fp32 state vs float64 oracle after 200 sequential ticks: the bound is
    # ~4x the measured drift at the time of writing (state 2e-3, cov 3e-3)
    np.testing.assert_allclose(
        np.asarray(s.x)[:n_active], oracle.x_t, atol=1e-2
    )
    np.testing.assert_allclose(
        np.asarray(s.P)[:n_active, :n_active], oracle.P_t, atol=1.5e-2
    )
    # padded dims stay exactly inert even with most slots active
    assert np.abs(np.asarray(s.x)[n_active:]).max(initial=0.0) == 0.0
    assert np.abs(np.asarray(s.P)[n_active:, :]).max(initial=0.0) == 0.0
    assert np.abs(np.asarray(s.P)[:, n_active:]).max(initial=0.0) == 0.0


def test_ukf_loc_trajectory_parity():
    rng = np.random.default_rng(31)
    cfg = _cfg(compat=True)
    lms = rng.uniform(-3, 3, size=(N_CAP, 2))
    oracle = _oracle(cfg, slam=False, true_map=lms)
    s = ukf.init(cfg, slam=False)
    tm = jnp.asarray(lms, jnp.float32)
    upd = jax.jit(
        lambda s, cmd, meas: ukf.update(
            cfg, s, cmd, meas, slam=False, true_map=tm
        )
    )
    script = _random_script(rng, n_ticks=25, n_lms=N_CAP)
    for cmd, meas in script:
        oracle.update(cmd, meas)
        s = upd(s, jnp.asarray(cmd, jnp.float32), _to_slots(meas, N_CAP))
    np.testing.assert_allclose(np.asarray(s.x), oracle.x_t, atol=5e-3)
    np.testing.assert_allclose(np.asarray(s.P), oracle.P_t, atol=5e-3)
    pose = np.asarray(ukf.pose(s))
    np.testing.assert_allclose(pose, oracle.pose(), atol=5e-3)
