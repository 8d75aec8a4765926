"""Pure Pursuit navigation as pure array math on a fixed-capacity path buffer.

Rebuild of planning_pkg/src/pure_pursuit.py: path paring within 0.15 m
(pure_pursuit.py:84-94), lookahead point by segment-circle intersection with a
radius growing 0.2 -> 2.0 by 1.25x (pure_pursuit.py:54-63,97-131), PID heading
control with loose/tight gain sets (pure_pursuit.py:17-37), command clamping
(pure_pursuit.py:78-80), and the `direct_nav` point-to-point alternative
(pure_pursuit.py:134-161).

The reference's mutable goal_queue list becomes a PyTree (fixed (C, 2) buffer
+ head/length indices); its while-loop radius growth becomes a parallel
evaluation over the static radius schedule with a first-valid select. All of
it runs inside the scanned closed-loop step under vmap.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from live_ekf_slam_tpu.core import pytree as struct

from live_ekf_slam_tpu.config import Config
from live_ekf_slam_tpu.utils.geometry import wrap_angle


@struct.dataclass
class PursuitState:
    path: jnp.ndarray      # (C, 2) waypoints in world coords
    head: jnp.ndarray      # () int32 index of first active waypoint
    length: jnp.ndarray    # () int32 number of active waypoints (from head)
    integ: jnp.ndarray     # () PID integral of heading error
    err_prev: jnp.ndarray  # () previous heading error


def init(cfg: Config) -> PursuitState:
    c = cfg.path_planning.path_capacity
    return PursuitState(
        path=jnp.zeros((c, 2), jnp.float32),
        head=jnp.int32(0),
        length=jnp.int32(0),
        integ=jnp.float32(0.0),
        err_prev=jnp.float32(0.0),
    )


def set_path(s: PursuitState, pts, valid) -> PursuitState:
    """Replace the whole queue with a new path ((L,2) + mask), compacted and
    padded/cropped to the fixed capacity."""
    c = s.path.shape[0]
    n = jnp.minimum(jnp.sum(valid.astype(jnp.int32)), c)
    order = jnp.argsort(~valid)  # valid entries first, stable
    compacted = pts[order]
    L = compacted.shape[0]
    if L >= c:
        path = compacted[:c]
    else:
        path = jnp.zeros((c, 2), compacted.dtype).at[:L].set(compacted)
    return s.replace(path=path, head=jnp.int32(0), length=n)


def append_goal(s: PursuitState, goal) -> PursuitState:
    """Append one point (the `simple`/blank-map mode, goal_pursuit_node.py:81-83)."""
    c = s.path.shape[0]
    idx = jnp.minimum(s.head + s.length, c - 1)
    return s.replace(
        path=s.path.at[idx].set(goal),
        length=jnp.minimum(s.length + 1, c - s.head),
    )


def _active_mask(s: PursuitState):
    idx = jnp.arange(s.path.shape[0])
    return (idx >= s.head) & (idx < s.head + s.length)


def pare_path(s: PursuitState, cur) -> PursuitState:
    """Drop waypoints up to the first one within 0.15 m (pure_pursuit.py:84-94)."""
    active = _active_mask(s)
    r = jnp.linalg.norm(s.path - cur[None, :2], axis=1)
    near = active & (r < 0.15)
    hit = jnp.any(near)
    first = jnp.argmax(near)  # lowest active index within range
    new_head = jnp.where(hit, first + 1, s.head)
    new_len = jnp.where(hit, s.length - (first + 1 - s.head), s.length)
    return s.replace(head=new_head, length=jnp.maximum(new_len, 0))


def _lookahead_at_radius(s: PursuitState, cur, radius):
    """Segment-circle intersection sweep (pure_pursuit.py:97-131): evaluate
    every consecutive segment; the reference keeps the LAST intersection
    found, preferring the smaller quadratic root."""
    c = s.path.shape[0]
    active = _active_mask(s)
    p_prev = s.path
    p_next = jnp.roll(s.path, -1, axis=0)
    seg_valid = active & jnp.roll(active, -1)  # segment i: pts i -> i+1

    diff = p_next - p_prev
    v1 = p_prev - cur[None, :2]
    a = jnp.sum(diff * diff, axis=1)
    b = 2.0 * jnp.sum(v1 * diff, axis=1)
    cc = jnp.sum(v1 * v1, axis=1) - radius * radius
    disc = b * b - 4.0 * a * cc
    ok = seg_valid & (disc >= 0.0) & (a > 0.0)
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    q0 = (-b - sq) / jnp.where(a > 0, 2.0 * a, 1.0)
    q1 = (-b + sq) / jnp.where(a > 0, 2.0 * a, 1.0)
    v0 = ok & (q0 >= 0.0) & (q0 <= 1.0)
    v1ok = ok & (q1 >= 0.0) & (q1 <= 1.0)
    q = jnp.where(v0, q0, q1)
    any_valid = v0 | v1ok
    pts = p_prev + q[:, None] * diff
    # last valid segment wins (the loop overwrites lookahead_pt)
    idx = jnp.arange(c)
    last = jnp.argmax(jnp.where(any_valid, idx, -1))
    found = jnp.any(any_valid)
    return pts[last], found


def choose_lookahead(cfg: Config, s: PursuitState, cur):
    """Growing-radius search (pure_pursuit.py:54-63): radii r0 * 1.25^k up to
    r_max, first radius that intersects the path wins; fall back to the first
    waypoint (pure_pursuit.py:61-63)."""
    r0 = cfg.path_planning.lookahead_dist_init
    rmax = cfg.path_planning.lookahead_dist_max
    n_radii = max(1, int(math.floor(math.log(rmax / r0, 1.25))) + 1)
    radii = jnp.asarray([r0 * 1.25 ** k for k in range(n_radii)], jnp.float32)

    pts, founds = jax.vmap(lambda r: _lookahead_at_radius(s, cur, r))(radii)
    first = jnp.argmax(founds)
    found = jnp.any(founds)
    single = s.length == 1
    first_pt = s.path[jnp.clip(s.head, 0, s.path.shape[0] - 1)]
    pt = jnp.where(found, pts[first], first_pt)
    pt = jnp.where(single, first_pt, pt)
    return pt


def _pid(cfg: Config, s: PursuitState, beta, tight: bool):
    """cmd_loose / cmd_tight gain sets (pure_pursuit.py:17-37)."""
    dt = cfg.dt
    if tight:
        ang = 0.5 * beta
        fwd = 0.02 * (1.0 - jnp.abs(beta / jnp.pi)) ** 12 + 0.01
    else:
        ang = (
            0.9 * beta
            + 0.01 * s.integ
            + 0.4 * (beta - s.err_prev) / dt
        )
        fwd = (1.0 - jnp.abs(beta / jnp.pi)) ** 4 + 0.05
    return fwd, ang


def get_next_cmd(cfg: Config, s: PursuitState, cur, tight: bool | None = None):
    """One navigation tick (pure_pursuit.py:40-81). Returns (cmd (2,), state')."""
    tight = cfg.tight_control if tight is None else tight
    s = pare_path(s, cur)
    have_path = s.length >= 1

    look = choose_lookahead(cfg, s, cur)
    gb = jnp.arctan2(look[1] - cur[1], look[0] - cur[0])
    beta = wrap_angle(gb - cur[2])

    integ = s.integ + beta * cfg.dt
    s_upd = s.replace(integ=integ)
    fwd, ang = _pid(cfg, s_upd, beta, tight)
    s_out = s_upd.replace(err_prev=beta)

    d_max = cfg.constraints.commands.d_max
    th_max = cfg.constraints.commands.th_max
    cmd = jnp.stack(
        [
            jnp.clip(fwd, 0.0, d_max),
            jnp.clip(ang, -th_max, th_max),
        ]
    )
    cmd = jnp.where(have_path, cmd, jnp.zeros(2))
    s_out = jax.tree.map(
        lambda new, old: jnp.where(have_path, new, old), s_out, s
    )
    return cmd, s_out


def direct_nav(cfg: Config, s: PursuitState, cur):
    """Point-to-point alternative (pure_pursuit.py:134-161)."""
    have_path = s.length >= 1
    goal = s.path[jnp.clip(s.head, 0, s.path.shape[0] - 1)]
    diff = goal - cur[:2]
    r = jnp.linalg.norm(diff)
    gb = jnp.arctan2(diff[1], diff[0])
    beta = wrap_angle(gb - cur[2])
    th_max = cfg.constraints.commands.th_max
    fwd = jnp.where(
        r > 0.1, (1.0 - jnp.abs(beta) / th_max) ** 3 + 0.05, 0.0
    )
    d_max = cfg.constraints.commands.d_max
    cmd = jnp.stack(
        [jnp.clip(fwd, 0.0, d_max), jnp.clip(beta, -th_max, th_max)]
    )
    cmd = jnp.where(have_path, cmd, jnp.zeros(2))
    arrived = have_path & (r < 0.15)
    s_out = s.replace(
        head=jnp.where(arrived, s.head + 1, s.head),
        length=jnp.where(arrived, s.length - 1, s.length),
    )
    return cmd, s_out
