"""Occupancy-grid path planning: device-native shortest path + local planner.

The reference's A* (planning_pkg/src/astar.py) is an inherently sequential
priority-queue search: sorted open list, Chebyshev heuristic, uniform step
cost (diagonals too), and a collision-escape rule — cells in collision are
traversable only from a parent in collision, with a +1000 priority penalty
(astar.py:80-127, 99-101, 176-177). On device we re-express it as bounded
min-plus relaxation (Bellman iterations over the whole 150^2 grid with masked
8-neighbor shifts): every sweep is a handful of vectorized ops,
`vmap`s over worlds, and converges in <= path-length sweeps. The result has
the same step-count cost as the reference's A* path whenever a free-only path
exists (tie-breaks may differ; the heuristic only affects expansion order).

`local_planner` (astar.py:12-56) — nearest free cell to a point ~1.8 m ahead —
becomes the same relaxation restricted to 4-neighbors over the occupied
region.

Host-side oracle implementations with exact reference semantics live in
planning/host.py (used for parity tests and the interactive host loop).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from live_ekf_slam_tpu.config import Config

_INF = jnp.float32(1e9)

# neighbor shifts: 4-connected first, then diagonals (goal_pursuit_node.py:149)
_SHIFTS4 = ((0, -1), (0, 1), (-1, 0), (1, 0))
_SHIFTS8 = _SHIFTS4 + ((-1, -1), (-1, 1), (1, -1), (1, 1))


def tf_ekf_to_map(cfg: Config, xy):
    """World -> grid indices, truncating toward zero (astar.py:137-139)."""
    i = (cfg.grid_shift - xy[..., 1] / cfg.grid_scale).astype(jnp.int32)
    j = (cfg.grid_shift + xy[..., 0] / cfg.grid_scale).astype(jnp.int32)
    return jnp.stack([i, j], axis=-1)


def tf_map_to_ekf(cfg: Config, ij):
    """Grid indices -> world coords (astar.py:131-133)."""
    x = (ij[..., 1].astype(jnp.float32) - cfg.grid_shift) * cfg.grid_scale
    y = -(ij[..., 0].astype(jnp.float32) - cfg.grid_shift) * cfg.grid_scale
    return jnp.stack([x, y], axis=-1)


def _shift_impl(a, di, dj, fill):
    """Shift a 2-D array by (di, dj), filling vacated cells."""
    out = jnp.full_like(a, fill)
    s = a.shape
    src_i = slice(max(0, -di), s[0] - max(0, di))
    dst_i = slice(max(0, di), s[0] + min(0, di))
    src_j = slice(max(0, -dj), s[1] - max(0, dj))
    dst_j = slice(max(0, dj), s[1] + min(0, dj))
    return out.at[dst_i, dst_j].set(a[src_i, src_j])


def distance_field(occ, start_ij, max_iters: int, diagonals: bool = True):
    """Min-plus relaxation distances from `start_ij` under the reference's
    traversal rule: into a free cell always; into a blocked cell only from a
    blocked cell (the collision-escape chain, astar.py:99-101).

    occ: (S, S) with 1=free, 0=blocked. Returns float32 (S, S) distances
    (1e9 where unreachable). Cost is 1 per step, diagonals included
    (astar.py Cell.g = parent.g + 1, astar.py:164).
    """
    free = occ > 0.5
    shifts = _SHIFTS8 if diagonals else _SHIFTS4
    s = occ.shape[0]
    dist0 = jnp.full((s, s), _INF).at[start_ij[0], start_ij[1]].set(0.0)

    def body(state):
        dist, _, it = state
        best = dist
        for (di, dj) in shifts:
            nb = _shift_impl(dist, di, dj, _INF)  # dist of neighbor (parent)
            nb_free = _shift_impl(free, di, dj, False)
            # allowed into this cell: free here, or blocked here & blocked parent
            allowed = free | (~free & ~nb_free)
            cand = jnp.where(allowed, nb + 1.0, _INF)
            best = jnp.minimum(best, cand)
        changed = jnp.any(best < dist)
        return best, changed, it + 1

    def cond(state):
        _, changed, it = state
        return changed & (it < max_iters)

    dist, _, _ = jax.lax.while_loop(
        cond, body, (dist0, jnp.asarray(True), jnp.int32(0))
    )
    return dist


def extract_path(dist, goal_ij, max_len: int, diagonals: bool = True):
    """Greedy descent from the goal along the distance field.

    Returns (path_ij (L, 2) int32 ordered start->goal excluding the start
    cell, valid (L,) bool, reached () bool). Matches the reference's
    parent-chain walk (astar.py:86-91) up to tie-breaking.
    """
    shifts = jnp.asarray(
        _SHIFTS8 if diagonals else _SHIFTS4, jnp.int32
    )
    s = dist.shape[0]
    d_goal = dist[goal_ij[0], goal_ij[1]]
    reached = d_goal < _INF

    def body(carry, _):
        cur, d_cur = carry
        nbrs = cur[None, :] + shifts  # (K, 2)
        nbrs = jnp.clip(nbrs, 0, s - 1)
        d_n = dist[nbrs[:, 0], nbrs[:, 1]]
        pick = jnp.argmin(jnp.where(d_n < d_cur, d_n, _INF))
        nxt = nbrs[pick]
        d_nxt = d_n[pick]
        step_ok = d_nxt < d_cur
        nxt = jnp.where(step_ok, nxt, cur)
        d_nxt = jnp.where(step_ok, d_nxt, d_cur)
        return (nxt, d_nxt), (cur, d_cur > 0)

    (_, _), (cells, valid) = jax.lax.scan(
        body, (jnp.asarray(goal_ij), d_goal), None, length=max_len
    )
    # cells are goal->start order; flip to start->goal and drop the start cell
    cells = cells[::-1]
    valid = valid[::-1] & reached
    return cells, valid, reached


def _window_offset(center_ij, window: int, s: int):
    """Top-left corner of a (window, window) crop centered on `center_ij`,
    clamped so the crop stays inside the (s, s) grid."""
    return jnp.clip(center_ij - window // 2, 0, s - window)


def astar(cfg: Config, occ, start_xy, goal_xy, max_iters=None, max_len=None):
    """Plan in world coordinates. Returns (path_xy (L, 2), valid (L,), reached).

    Equivalent role to Astar.astar + interpret_astar_path (astar.py:59-155):
    the returned path is start->goal in world coords, excluding the start.

    When `cfg.path_planning.astar_window > 0` the relaxation runs on a
    static (window, window) crop centered on the start cell (trace-time
    constant shape; the crop is a `dynamic_slice`). A goal outside the
    window reports reached=False; paths inside it are identical to the
    full-grid result whenever a shortest path stays in the window — which
    the ~18-cell igvc local plans always do.
    """
    it = max_iters or cfg.path_planning.astar_max_iters
    ln = max_len or it
    diag = cfg.path_planning.astar_incl_diagonals
    win = cfg.path_planning.astar_window
    start_ij = tf_ekf_to_map(cfg, jnp.asarray(start_xy))
    goal_ij = tf_ekf_to_map(cfg, jnp.asarray(goal_xy))
    s = occ.shape[0]
    start_ij = jnp.clip(start_ij, 0, s - 1)
    goal_ij = jnp.clip(goal_ij, 0, s - 1)
    if win and win < s:
        off = _window_offset(start_ij, win, s)
        occ_w = jax.lax.dynamic_slice(occ, (off[0], off[1]), (win, win))
        goal_w = goal_ij - off
        inside = jnp.all((goal_w >= 0) & (goal_w < win))
        dist = distance_field(occ_w, start_ij - off, it, diag)
        cells, valid, reached = extract_path(
            dist, jnp.clip(goal_w, 0, win - 1), ln, diag
        )
        return (
            tf_map_to_ekf(cfg, cells + off[None, :]),
            valid & inside,
            reached & inside,
        )
    dist = distance_field(occ, start_ij, it, diag)
    cells, valid, reached = extract_path(dist, goal_ij, ln, diag)
    return tf_map_to_ekf(cfg, cells), valid, reached


def local_planner(cfg: Config, occ, cur_pose, max_iters=None):
    """Choose a free point ~local_planner_dist ahead (astar.py:12-56).

    Returns (goal_xy (2,), ok () bool). If the ideal cell is blocked, the
    nearest free cell by 4-connected BFS distance over the blocked region is
    chosen (tie-breaks may differ from the reference's queue order).
    """
    it = max_iters or cfg.path_planning.local_astar_max_iters
    d = cfg.path_planning.local_planner_dist
    pt = jnp.stack(
        [
            cur_pose[0] + d * jnp.cos(cur_pose[2]),
            cur_pose[1] + d * jnp.sin(cur_pose[2]),
        ]
    )
    full = occ.shape[0]
    ij = jnp.clip(tf_ekf_to_map(cfg, pt), 0, full - 1)
    win = cfg.path_planning.astar_window
    if win and win < full:
        # same static crop as astar(): the BFS spill from the ideal cell is
        # a few cells (barrel-sized obstacles), so a window centered on it
        # bounds the search radius at win//2 — the bounded-iteration
        # semantics this function already has, on 5-6x fewer cells.
        off = _window_offset(ij, win, full)
        occ_l, ij_l, s = jax.lax.dynamic_slice(
            occ, (off[0], off[1]), (win, win)), ij - off, win
    else:
        off = jnp.zeros((2,), ij.dtype)
        occ_l, ij_l, s = occ, ij, full
    free = occ_l > 0.5

    ideal_free = free[ij_l[0], ij_l[1]]

    # BFS distance from the ideal cell *through blocked cells only*; free
    # cells terminate the search (astar.py:38-54).
    dist0 = jnp.full((s, s), _INF).at[ij_l[0], ij_l[1]].set(0.0)

    def body(state):
        dist, _, k = state
        best = dist
        for (di, dj) in _SHIFTS4:
            nb = _shift_impl(dist, di, dj, _INF)
            nb_blocked = ~_shift_impl(free, di, dj, True)
            # propagate through blocked parents (start cell counts as blocked
            # frontier); free cells receive a distance but don't propagate —
            # handled by masking the parent side.
            parent_ok = nb_blocked | (nb == 0.0)
            cand = jnp.where(parent_ok, nb + 1.0, _INF)
            best = jnp.minimum(best, cand)
        changed = jnp.any(best < dist)
        return best, changed, k + 1

    dist, _, _ = jax.lax.while_loop(
        lambda st: st[1] & (st[2] < it),
        body,
        (dist0, jnp.asarray(True), jnp.int32(0)),
    )
    # nearest free cell: min distance among free cells; deterministic
    # row-major tie-break via argmin.
    masked = jnp.where(free, dist, _INF)
    flat = jnp.argmin(masked)
    best_ij = jnp.stack([flat // s, flat % s]).astype(jnp.int32) + off
    found = masked.reshape(-1)[flat] < _INF
    out_ij = jnp.where(ideal_free, ij, best_ij)
    goal = tf_map_to_ekf(cfg, out_ij)
    return goal, ideal_free | found
