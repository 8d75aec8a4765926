"""live_ekf_slam_tpu — a JAX/XLA online EKF-SLAM framework for accelerators.

A from-scratch rebuild of the capabilities of the ROS1 `live_ekf_slam` reference
(kevin-robb/live_ekf_slam): a 2-D unicycle simulator with noisy commands and
FOV-culled range-bearing landmark measurements, online SLAM filters (naive
command propagation, EKF-SLAM, UKF localization & SLAM, pose-graph SLAM via a
batched Gauss-Newton/LM solver replacing GTSAM), occupancy-grid A* planning and
Pure Pursuit control for closed-loop runs.

Architecture: the reference's pub/sub-of-small-messages design dissolves into a
single pure function ``step(carry, inputs) -> (carry', frame)`` run under
``jax.lax.scan`` and ``jax.vmap`` over thousands of independent worlds, with
fixed-capacity masked state (no dynamic shapes), sharded across devices with
``jax.sharding``. The EKF-SLAM Monte-Carlo rollout also runs as one CUDA
kernel on NVIDIA GPUs (ops/fused_rollout.py). See SURVEY.md at the repo root for the layer map of
the reference and the build plan.
"""

__version__ = "0.1.0"

from live_ekf_slam_tpu.config import Config, load_config, preset  # noqa: F401
