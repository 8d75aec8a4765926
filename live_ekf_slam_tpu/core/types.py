"""Typed PyTree state containers (static shapes; masked dynamic extents).

The reference grows its filter state with ``conservativeResize`` as landmarks
are discovered (ekf.cpp:146, ukf.cpp:171,357) and its pose graph one node per
tick (pose_graph.cpp:222,247). XLA requires static shapes, so every container
here is allocated at fixed capacity up front with an active-extent integer
(``M``/``timestep``) and per-slot validity masks; a masked no-op update is an
exact identity on the state. All containers are pytree dataclasses
(core/pytree.py) so they flow through jit/vmap/scan and shard trivially over
a world batch axis.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp
from live_ekf_slam_tpu.core import pytree as struct


@struct.dataclass
class WorldState:
    """Ground-truth world (the reference's sim_node globals, sim_node.py:32).

    pose: (3,) true vehicle (x, y, theta); theta deliberately unwrapped, as in
        sim_node.py:222.
    landmarks: (N, 2) true landmark positions; slot index == landmark id
        (the sim always numbers ids 0..N-1, sim_node.py:155-195).
    num_landmarks: scalar int32, number of active landmark slots.
    """

    pose: jnp.ndarray
    landmarks: jnp.ndarray
    num_landmarks: jnp.ndarray


@struct.dataclass
class Measurements:
    """One tick's landmark detections (the `/landmark` Float32MultiArray
    [id, r, b]* message, sim_node.py:244-250) in fixed slots.

    Slots are ordered by ascending landmark id (the sim iterates ids in order,
    sim_node.py:231), matching the sequential-update order of the C++ filters.
    """

    ids: jnp.ndarray    # (K,) int32, -1 for empty slots
    r: jnp.ndarray      # (K,) float32 noisy range
    b: jnp.ndarray      # (K,) float32 noisy bearing
    valid: jnp.ndarray  # (K,) bool
    overflow: jnp.ndarray  # () bool — true if >K landmarks were visible


@struct.dataclass
class NaiveState:
    """Naive command-propagation filter state (filter.h:325-370)."""

    pose: jnp.ndarray      # (3,)
    timestep: jnp.ndarray  # () int32


@struct.dataclass
class GaussianState:
    """EKF-SLAM padded state (ekf.cpp; state (x,y,theta,lm...) of dim 3+2N).

    x: (D,) mean, D = 3+2N; inactive landmark slots hold zeros/garbage that is
        provably never read by active-slot math (insertion fully overwrites
        its rows/cols — see models/ekf.py).
    P: (D, D) covariance.
    ids: (N,) int32 landmark id per slot in discovery order (lm_IDs,
        filter.h:70); -1 when empty.
    M: () int32 number of active landmarks.
    """

    x: jnp.ndarray
    P: jnp.ndarray
    ids: jnp.ndarray
    M: jnp.ndarray
    timestep: jnp.ndarray


@struct.dataclass
class UKFState:
    """UKF padded state over (x, y, cos t, sin t, lm...) of dim 4+2N
    (ukf.cpp:33; filter.h:177-223).

    X: (Du, 2*Du+1) last sigma points (kept for viz parity with
        UKFState.msg's X field). slam: True => UKF-SLAM, False => UKF-Loc
        (fixed 4-dim state, true map known).
    """

    x: jnp.ndarray
    P: jnp.ndarray
    ids: jnp.ndarray
    M: jnp.ndarray
    timestep: jnp.ndarray
    X: jnp.ndarray


@struct.dataclass
class PoseGraphState:
    """Online factor-graph accumulator (pose_graph.cpp) as fixed tensors.

    Poses are keyed by timestep (0..T); landmarks by slot in discovery order.
    One between-factor per tick (pose_graph.cpp:222) and up to K bearing-range
    factors per tick (pose_graph.cpp:174), all masked.
    """

    # initial values (seeded from the secondary filter, pose_graph.cpp:247)
    poses_init: jnp.ndarray   # (T+1, 3)
    lms_init: jnp.ndarray     # (N, 2)
    # odometry factors: tick t connects pose t -> t+1 with (fwd, ang)
    odom: jnp.ndarray         # (T, 2)
    odom_valid: jnp.ndarray   # (T,) bool
    # measurement factors per tick/slot
    meas_rb: jnp.ndarray      # (T, K, 2) (range, bearing)
    meas_lm: jnp.ndarray      # (T, K) int32 landmark slot index
    meas_valid: jnp.ndarray   # (T, K) bool
    # landmark bookkeeping
    ids: jnp.ndarray          # (N,) int32
    M: jnp.ndarray            # () int32
    timestep: jnp.ndarray     # () int32
    # current naive/secondary pose estimate (cur_veh_pose_estimate,
    # pose_graph.cpp:264)
    cur_pose: jnp.ndarray     # (3,)
    # last solution (poses, lms) if solved
    poses_sol: jnp.ndarray    # (T+1, 3)
    lms_sol: jnp.ndarray      # (N, 2)
    solved: jnp.ndarray       # () bool


FilterState = Any  # union of the above filter states
