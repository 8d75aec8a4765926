"""Test config: the CPU backend with 8 virtual devices, so sharding tests run
on any host and float32 math is deterministic.

JAX_PLATFORMS defaults to cpu here; GPU-only tests (marker ``gpu``) skip
unless the run selects the GPU (``JAX_PLATFORMS=cuda python -m pytest -m
gpu``). ``python chip_smoke.py`` drives the same kernels on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402,F401

# ---------------------------------------------------------------------------
# quick/slow tiers: `make test-quick` (-m "not slow")
# keeps the edit loop under ~3 min on one CPU core; the full suite stays the
# CI gate. Names listed here measured >=14 s in a
# --durations=0 run; marking is centralized so the threshold stays auditable.
import pytest  # noqa: E402

_SLOW = {
    "test_reference_parity_smoke",
    "test_streams_path_matches_scan_path_iekf",
    "test_streams_replay_prefix_windows_exact",
    "test_chordal_init_survives_adversarial_seeding",
    "test_pgs_beats_naive_at_reference_scale",
    "test_streams_path_iterative_matches_scan_path",
    "test_calibrated_ekf_beats_default_at_reference_protocol",
    "test_streams_path_matches_scan_path_ekf",
    "test_exact_logmap_delta_below_noise_floor",
    "test_lm_converges_to_global_optimum",
    "test_trajectory_parity",
    "test_iterative_mode_on_device",
    "test_streams_path_matches_scan_path_naive",
    "test_schur_solver_matches_dense",
    "test_update_landmarks_after_adding",
    "test_iekf_end_to_end_accuracy",
    "test_matrix_free_matvecs_match_dense",
    "test_iterative_pgs_mode",
    "test_iekf_consistency_advantage",
    "test_inactive_slots_stay_inert",
    "test_iekf_long_horizon_fp32_stability",
    "test_single_step_parity_tight",
    "test_igvc_closed_loop_progresses",
    "test_igvc_closed_loop_scale",
    "test_igvc_closed_loop_sharded_bitwise",
    "test_ukf_slam_long_horizon_parity",
    "test_monte_carlo_orderings",
}


def pytest_collection_modifyitems(config, items):
    import warnings

    seen = set()
    for item in items:
        base = getattr(item, "originalname", None) or item.name
        if base in _SLOW or item.name in _SLOW:
            item.add_marker(pytest.mark.slow)
            seen.add(base if base in _SLOW else item.name)
    # a renamed slow test must not silently rejoin the quick tier: warn
    # loudly when a _SLOW entry matches nothing. Only meaningful when the
    # whole suite was collected (single-file runs see a subset).
    full_run = all(
        a.rstrip("/").endswith("tests") for a in config.args
    ) if config.args else True
    stale = _SLOW - seen
    if stale and full_run:
        warnings.warn(pytest.PytestWarning(
            f"tests/conftest.py _SLOW entries match no test "
            f"(renamed? now silently in the quick tier): {sorted(stale)}"
        ))


@pytest.fixture(params=[
    pytest.param("reference"),
    pytest.param("interpret"),
    pytest.param("kernel", marks=pytest.mark.gpu),
])
def rollout(request):
    """The fused-rollout implementation under test: the plain-JAX reference
    everywhere, the kernel's host build (interpret mode) on the CPU backend,
    the CUDA kernel only where the backend is a GPU."""
    import functools

    from live_ekf_slam_tpu.ops import fused_rollout as fr

    backend = jax.default_backend()
    if request.param == "reference":
        return fr.reference_ekf_rollout
    if request.param == "interpret":
        if backend != "cpu":
            pytest.skip("the kernel's host build runs on the CPU backend")
        return functools.partial(fr.fused_ekf_rollout, interpret=True)
    if backend != "gpu":
        pytest.skip("CUDA kernel: needs a GPU backend")
    return fr.fused_ekf_rollout
