"""Monte-Carlo evaluation engine: vmap(scan(fused step)) over worlds.

This is where the reference's whole process graph collapses: sim_node's truth
propagation + sensing (sim_node.py:209-250), localization_node's
queue-pop-one-pair-per-tick driver (localization_node.cpp:108-140, including
the secondary-filter coupling for pose-graph SLAM), and the plotter's error
accumulation (plotting_node.py:195-218) all fuse into ONE pure function
`step(carry, cmd_and_key)` executed under `lax.scan`, then `vmap`-ed over a
batch of independent worlds and shardable over a device mesh (see parallel/).
"""

from __future__ import annotations

import functools
import os
import sys
import time
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from live_ekf_slam_tpu.core import pytree as struct

from live_ekf_slam_tpu.config import Config
from live_ekf_slam_tpu.core.types import WorldState
from live_ekf_slam_tpu.models import ekf, iekf, naive, posegraph, ukf
from live_ekf_slam_tpu.sim import maps as sim_maps
from live_ekf_slam_tpu.sim.trajectory import generate_trajectory
from live_ekf_slam_tpu.sim.world import init_world, sim_step

ONLINE_FILTERS = ("ekf_slam", "iekf_slam", "ukf_loc", "ukf_slam", "naive")

# Graph-prefix window quantum for the iterative streams replay (see
# run_monte_carlo_pg_streams.make_rep_fn); module-level so tests can shrink
# it to exercise multi-window replays at small T.
REPLAY_CAP_STEP = 256


def _vlog(msg: str) -> None:
    """Timestamped progress lines for long runs, gated on
    LIVE_EKF_VERBOSE=1."""
    if os.environ.get("LIVE_EKF_VERBOSE"):
        print(f"[runner {time.strftime('%H:%M:%S')}] {msg}",
              file=sys.stderr, flush=True)


@struct.dataclass
class RunCarry:
    world: WorldState
    primary: Any
    secondary: Any          # None unless primary is pose_graph
    err_sum_primary: jnp.ndarray
    err_sum_secondary: jnp.ndarray
    # per-world divergence masks (SURVEY §5; the role of ukf.cpp:207-211's
    # try/catch): once a filter's pose estimate goes non-finite or absurdly
    # far, the world is flagged and its error stops accumulating so one
    # diverged world cannot poison batch statistics.
    alive_primary: jnp.ndarray = struct.field(default=None)
    alive_secondary: jnp.ndarray = struct.field(default=None)
    ticks_primary: jnp.ndarray = struct.field(default=None)
    ticks_secondary: jnp.ndarray = struct.field(default=None)


# a pose estimate farther than this from truth marks the world diverged
# (the map spans ~2*bound = 20 m; 50 m means the filter is unrecoverable)
DIVERGENCE_RADIUS = 50.0


def _filter_init(cfg: Config, name: str, init_pose=None):
    if name == "ekf_slam":
        return ekf.init(cfg, init_pose)
    if name == "iekf_slam":
        return iekf.init(cfg, init_pose)
    if name == "ukf_slam":
        return ukf.init(cfg, slam=True, init_pose=init_pose)
    if name == "ukf_loc":
        return ukf.init(cfg, slam=False, init_pose=init_pose)
    if name == "naive":
        return naive.init(cfg, init_pose)
    if name == "pose_graph":
        return posegraph.init(cfg, init_pose)
    raise ValueError(f"Invalid filter choice {name!r} (params.yaml:11)")


def _filter_update(cfg: Config, name: str, state, cmd, meas, true_map=None):
    if name == "ekf_slam":
        return ekf.update(cfg, state, cmd, meas)
    if name == "iekf_slam":
        return iekf.update(cfg, state, cmd, meas)
    if name == "ukf_slam":
        return ukf.update(cfg, state, cmd, meas, slam=True)
    if name == "ukf_loc":
        return ukf.update(cfg, state, cmd, meas, slam=False, true_map=true_map)
    if name == "naive":
        return naive.update(cfg, state, cmd, meas)
    raise ValueError(name)


def _filter_pose(name: str, state):
    if name in ("ekf_slam", "iekf_slam"):
        return ekf.pose(state)
    if name in ("ukf_slam", "ukf_loc"):
        return ukf.pose(state)
    if name == "naive":
        return state.pose
    raise ValueError(name)


def _filter_state_vector(cfg: Config, name: str, state):
    if name in ("ekf_slam", "iekf_slam"):
        return ekf.state_vector(state)
    if name == "ukf_slam":
        return ukf.state_vector(cfg, state, slam=True)
    if name == "ukf_loc":
        return ukf.state_vector(cfg, state, slam=False)
    if name == "naive":
        return naive.state_vector(state)
    raise ValueError(name)


def _filter_landmarks(cfg: Config, name: str, state):
    """(lm_xy (N, 2), ids, M) of a SLAM secondary, for the pose graph's
    update_landmarks_after_adding coupling (pose_graph.cpp:111-118); None for
    filters without landmark estimates."""
    if name in ("ekf_slam", "iekf_slam"):
        return state.x[3:].reshape(-1, 2), state.ids, state.M
    if name == "ukf_slam":
        return state.x[4:].reshape(-1, 2), state.ids, state.M
    return None


def make_step(cfg: Config, collect: str = "sums"):
    """Build the fused per-tick step for cfg.filter.

    collect: "sums" (running error only — fastest, the bench path) or
    "poses" (additionally emit (true, est) poses per tick for viz/pose-graph
    metrics).
    """
    primary = cfg.filter
    secondary = (
        cfg.pose_graph.filter_to_compare if primary == "pose_graph" else None
    )
    if primary == "pose_graph" and secondary == "pose_graph":
        raise ValueError("Cannot instantiate two instances of the same filter.")

    def step(carry: RunCarry, inp):
        # inp is (cmd, key) or (cmd, key, tick); tick is the global tick
        # index threaded through the scan UNBATCHED (identical across
        # worlds), which keeps the pose-graph tensor writes scatter-free
        # under vmap (models/posegraph.py:_set_row)
        cmd, key, *rest = inp
        tick = rest[0] if rest else None
        world, meas = sim_step(cfg, carry.world, cmd, key)
        truth_xy = world.pose[:2]

        sec_state = carry.secondary
        err_sec = carry.err_sum_secondary
        if primary == "pose_graph":
            # localization_node.cpp:123-131: secondary updates first, primary
            # is told its state, then primary updates.
            sec_state = _filter_update(
                cfg, secondary, sec_state, cmd, meas,
                true_map=world.landmarks,
            )
            sec_pose = _filter_pose(secondary, sec_state)
            sec_lms = _filter_landmarks(cfg, secondary, sec_state)
            pg = posegraph.update_naive_estimate(
                carry.primary,
                _filter_state_vector(cfg, secondary, sec_state),
                secondary_lms=None if sec_lms is None else sec_lms[0],
                secondary_ids=None if sec_lms is None else sec_lms[1],
                secondary_m=None if sec_lms is None else sec_lms[2],
                update_landmarks=(
                    cfg.pose_graph.update_landmarks_after_adding
                    and sec_lms is not None
                ),
            )
            m_prev = pg.M
            prim_state = posegraph.update(cfg, pg, cmd, meas, tick=tick)
            if cfg.pose_graph.solve_graph_every_iteration:
                # the reference's default mode (pose_graph.cpp:262-267):
                # re-solve every tick, feeding the result back as the next
                # initial estimate (incremental PCG-GN, models/posegraph.py)
                node_t = None if tick is None else jnp.minimum(
                    tick + 1, jnp.int32(cfg.num_iterations) - 1
                )
                prim_state = posegraph.solve_iteration(
                    cfg, prim_state, m_prev, node_t=node_t
                )
            est_pose = sec_pose  # published state is the secondary's
        else:
            prim_state = _filter_update(
                cfg, primary, carry.primary, cmd, meas,
                true_map=world.landmarks,
            )
            est_pose = _filter_pose(primary, prim_state)

        def guard(alive, ticks, err_sum, pose):
            e = jnp.linalg.norm(pose[:2] - truth_xy)
            ok = alive & jnp.isfinite(e) & (e < DIVERGENCE_RADIUS)
            err_new = jnp.where(ok, err_sum + e, err_sum)
            return ok, jnp.where(ok, ticks + 1, ticks), err_new

        alive_p, ticks_p, err_prim = guard(
            carry.alive_primary, carry.ticks_primary,
            carry.err_sum_primary, est_pose,
        )
        if primary == "pose_graph":
            # est_pose IS the secondary's pose here (published state); the
            # secondary mask mirrors it
            alive_s, ticks_s, err_sec = alive_p, ticks_p, err_prim
        else:
            alive_s, ticks_s = carry.alive_secondary, carry.ticks_secondary
        new_carry = RunCarry(
            world=world,
            primary=prim_state,
            secondary=sec_state,
            err_sum_primary=err_prim,
            err_sum_secondary=err_sec,
            alive_primary=alive_p,
            alive_secondary=alive_s,
            ticks_primary=ticks_p,
            ticks_secondary=ticks_s,
        )
        if collect == "poses":
            out = (world.pose, est_pose)
        else:
            out = None
        return new_carry, out

    return step


def init_carry(cfg: Config, landmarks, n_active=None, init_pose=None) -> RunCarry:
    world = init_world(cfg, landmarks, n_active, init_pose)
    primary = _filter_init(cfg, cfg.filter, init_pose)
    secondary = None
    if cfg.filter == "pose_graph":
        secondary = _filter_init(cfg, cfg.pose_graph.filter_to_compare, init_pose)
    return RunCarry(
        world=world,
        primary=primary,
        secondary=secondary,
        err_sum_primary=jnp.float32(0.0),
        err_sum_secondary=jnp.float32(0.0),
        alive_primary=jnp.asarray(True),
        alive_secondary=jnp.asarray(True),
        ticks_primary=jnp.int32(0),
        ticks_secondary=jnp.int32(0),
    )


def rollout(cfg: Config, carry: RunCarry, cmds, key, collect: str = "sums"):
    """Scan the fused step over a (T, 2) command sequence for one world."""
    step = make_step(cfg, collect)
    t_total = cmds.shape[0]
    keys = jax.random.split(key, t_total)
    final, outs = jax.lax.scan(
        step, carry, (cmds, keys, jnp.arange(t_total, dtype=jnp.int32))
    )
    return final, outs


def _single_world_run(cfg: Config, collect: str, landmarks, key):
    """world init + trajectory precompute + rollout; vmap target."""
    k_traj, k_roll = jax.random.split(key)
    n_active = landmarks.shape[0]
    carry = init_carry(cfg, landmarks, n_active)
    if cfg.precompute_trajectory:
        cmds = generate_trajectory(cfg, landmarks, n_active, k_traj)
    else:
        # open-loop kickoff-only runs still tick the sim with zero commands
        cmds = jnp.zeros((cfg.num_iterations, 2), jnp.float32)
    final, outs = rollout(cfg, carry, cmds, k_roll, collect)
    return final, outs


def _batched_rollout(cfg: Config, collect, lms, keys):
    """scan(vmap(step)) over the whole rollout in one device call; key
    handling mirrors _single_world_run exactly."""
    t_total = cfg.num_iterations
    step = make_step(cfg, collect)

    @jax.jit
    def run(lms, keys):
        def one(l, k):
            k_traj, k_roll = jax.random.split(k)
            carry = init_carry(cfg, l, l.shape[0])
            if cfg.precompute_trajectory:
                cmds = generate_trajectory(cfg, l, l.shape[0], k_traj)
            else:
                cmds = jnp.zeros((t_total, 2), jnp.float32)
            return carry, cmds, jax.random.split(k_roll, t_total)

        carry, cmds, tick_keys = jax.vmap(one)(lms, keys)

        def batched(c, inp):
            # the tick (inp[2]) stays unbatched: all worlds share it
            return jax.vmap(step, in_axes=(0, (0, 0, None)))(c, inp)

        final, outs = jax.lax.scan(
            batched, carry,
            (jnp.swapaxes(cmds, 0, 1), jnp.swapaxes(tick_keys, 0, 1),
             jnp.arange(t_total, dtype=jnp.int32)),
        )
        # scan-major (T, B, ...) -> world-major (B, T, ...)
        return final, jax.tree.map(lambda x: jnp.swapaxes(x, 0, 1), outs)

    return run(lms, keys)


def run_monte_carlo(
    cfg: Config,
    key,
    batch: int,
    seed: int = 0,
    collect: str = "sums",
    solve_chunk: int = 8,
    jit: bool = True,
    impl: str = "xla",
):
    """Full Monte-Carlo evaluation: B worlds, random maps, TSP trajectories.

    Returns a dict of (B,) per-world average position errors, reproducing the
    reference's benchmark harness (data/<run>/*.csv) in one call.

    impl="fused" routes EKF-SLAM / RI-EKF-SLAM runs through the fused
    rollout kernel (ops/fused_rollout.py), which needs a CUDA GPU; requires
    known landmark ids and collect == "sums".
    """
    cfg, lms = _gen_maps(cfg, np.random.default_rng(seed), batch)
    keys = jax.random.split(key, batch)

    if impl == "fused":
        from live_ekf_slam_tpu.ops.fused_rollout import (
            fused_ekf_rollout, rollout_noise,
        )

        if cfg.filter not in ("ekf_slam", "iekf_slam") or collect != "sums":
            raise ValueError(
                "impl='fused' supports filter in (ekf_slam, iekf_slam) with "
                f"collect='sums', got filter={cfg.filter!r}, "
                f"collect={collect!r}; the UKF filters run with impl='xla'"
            )
        cmds = jax.jit(
            jax.vmap(lambda l, k: generate_trajectory(cfg, l, l.shape[0], k))
        )(lms, keys)
        noise = rollout_noise(
            jax.random.fold_in(key, 1), batch, cfg.num_iterations,
            lms.shape[1],
        )
        out = fused_ekf_rollout(
            cfg, lms, cmds, noise,
            filter_kind="iekf" if cfg.filter == "iekf_slam" else "ekf",
        )
        # same latch semantics as the XLA path's per-tick guard: a world is
        # diverged once its INSTANTANEOUS error ever exceeded the radius
        # (the kernels track the running max), not when the run mean does —
        # so late-rollout divergence flags identically across impls
        err_max = np.asarray(out["err_max"])
        diverged = ~np.isfinite(err_max) | (err_max > DIVERGENCE_RADIUS)
        err = np.asarray(out["err_sum"]) / cfg.num_iterations
        results = {
            "err_" + cfg.filter: err,
            "diverged_" + cfg.filter: diverged | ~np.isfinite(err),
        }
        return results, out, None
    if impl != "xla":
        raise ValueError(f"impl must be 'xla' or 'fused', got {impl!r}")

    if jit:
        final, outs = _batched_rollout(cfg, collect, lms, keys)
    else:
        fn = functools.partial(_single_world_run, cfg, collect)
        final, outs = jax.vmap(fn)(lms, keys)

    t_total = cfg.num_iterations
    # per-world average error over the ticks the filter was alive; diverged
    # worlds (non-finite estimate or >DIVERGENCE_RADIUS from truth) stop
    # accumulating and are surfaced as masks so they can't poison means
    ticks_p = np.maximum(np.asarray(final.ticks_primary), 1)
    results = {
        "err_" + cfg.filter: np.asarray(final.err_sum_primary) / ticks_p,
        "diverged_" + cfg.filter: ~np.asarray(final.alive_primary),
    }
    if cfg.filter == "pose_graph":
        ticks_s = np.maximum(np.asarray(final.ticks_secondary), 1)
        results["err_" + cfg.pose_graph.filter_to_compare] = (
            np.asarray(final.err_sum_secondary) / ticks_s
        )
        results["diverged_" + cfg.pose_graph.filter_to_compare] = ~np.asarray(
            final.alive_secondary
        )
        # Solve the accumulated graphs.
        if collect != "poses":
            raise ValueError("pose_graph runs need collect='poses' for metrics")
        true_poses = outs[0]  # (B, T, 3)
        err_pg, err_pg_init = _pg_bulk_solve(
            cfg, final.primary, true_poses, batch, solve_chunk
        )
        results["err_pose_graph_result"] = err_pg
        results["err_pose_graph_initial"] = err_pg_init
    return results, final, outs


def _gen_maps(cfg: Config, rng, batch):
    """Per-world landmark maps for a Monte-Carlo run; returns (cfg, (B, N, 2))
    with capacities grown to fixed maps' landmark counts."""
    if cfg.landmark_map in ("random", "rand"):
        # occupancy-aware rejection (sim_node.py:177-188): random landmarks
        # never land on obstacles of the configured occupancy map
        occ, _ = sim_maps.load_occ_map(cfg)
        lms = sim_maps.random_landmarks_batched(cfg, rng, batch, occ=occ)
    else:
        single, n_active = sim_maps.make_landmarks(cfg, rng)
        # fixed maps (demo/grid/igvc1) set their own landmark count
        # (sim_node.py:165,176,192); grow the slot capacities to match
        if n_active != cfg.num_landmark_slots:
            cfg = cfg.replace(
                num_landmark_slots=n_active, num_meas_slots=n_active
            )
        lms = np.broadcast_to(single[None], (batch,) + single.shape).copy()
    return cfg, jnp.asarray(lms)


def run_monte_carlo_pg_streams(
    cfg: Config,
    key,
    batch: int,
    seed: int = 0,
    solve_chunk: int = 8,
    world_chunk: int = 256,
    impl: str = "fused",
):
    """Fast pose-graph Monte Carlo: closed-form sim streams + vectorized graph
    assembly + bulk solve — no per-tick accumulation scan.

    In the scan path (run_monte_carlo) graph accumulation and the secondary
    filter ride a per-tick XLA step. Here the simulator and the naive
    secondary are closed-form cumsums (sim/streams.py), the EKF / RI-EKF
    secondary runs as one fused rollout with the SAME injected noise draws
    (ops/fused_rollout.py emit_traj; impl="fused" is the CUDA kernel,
    impl="reference" its plain-JAX twin), and posegraph.assemble_streams
    builds every graph tensor in O(T*N) vector ops (parity-tested against
    the update() scan). Supports
    naive and ekf_slam secondaries in BOTH solve modes: iterative mode
    (solve_graph_every_iteration) re-enacts the per-tick incremental solves
    on the assembled graphs (posegraph.replay_iterative — the same solver
    calls as the in-scan path, minus the per-tick sim/filter overhead). The
    scan path remains the reference implementation.

    Returns (results, None, None): the same results dict shape as
    run_monte_carlo; graph tensors stay on device (chunk-local) and are not
    returned — per-chunk solves read back only per-world metric vectors.
    """
    if cfg.filter != "pose_graph":
        raise ValueError("run_monte_carlo_pg_streams requires filter=pose_graph")
    if cfg.pose_graph.update_landmarks_after_adding:
        raise ValueError(
            "streams path does not support update_landmarks_after_adding"
        )
    secondary = cfg.pose_graph.filter_to_compare
    if secondary not in ("naive", "ekf_slam", "iekf_slam"):
        raise ValueError(
            "streams path supports naive/ekf_slam/iekf_slam secondary, "
            f"got {secondary}"
        )

    from live_ekf_slam_tpu.ops import fused_rollout
    from live_ekf_slam_tpu.sim.streams import naive_deadreckon, sim_streams

    rollouts = {
        "fused": fused_rollout.fused_ekf_rollout,
        "reference": fused_rollout.reference_ekf_rollout,
    }
    if impl not in rollouts:
        raise ValueError(f"impl must be one of {sorted(rollouts)}, got {impl!r}")
    rollout = rollouts[impl]

    cfg, lms_all = _gen_maps(cfg, np.random.default_rng(seed), batch)
    keys = jax.random.split(key, batch)
    n_active = cfg.num_landmark_slots

    @jax.jit
    def gen_chunk(lms_c, keys_c):
        def one(l, k):
            k_traj, k_roll = jax.random.split(k)
            if cfg.precompute_trajectory:
                cmds = generate_trajectory(cfg, l, n_active, k_traj)
            else:
                cmds = jnp.zeros((cfg.num_iterations, 2), jnp.float32)
            st = sim_streams(cfg, l, n_active, cmds, k_roll)
            return cmds, st

        return jax.vmap(one)(lms_c, keys_c)

    t_total = cfg.num_iterations
    iterative = cfg.pose_graph.solve_graph_every_iteration

    @jax.jit
    def assemble_chunk(est_c, st_c, cmds_c):
        graphs = jax.vmap(
            lambda e, r, b, v, c: posegraph.assemble_streams(
                cfg, e, r, b, v, c
            )
        )(est_c, st_c["r"], st_c["b"], st_c["vis"], cmds_c)
        # per-tick landmark counts for the iterative replay: m_at[t] =
        # #{first sightings <= t} (insertions happen on live ticks only)
        tidx = jnp.arange(t_total)
        vis_live = st_c["vis"] & (tidx < t_total - 1)[None, :, None]
        first_t = jnp.where(
            jnp.any(vis_live, axis=1), jnp.argmax(vis_live, axis=1), t_total
        )  # (B, N)
        m_at = jnp.sum(
            (first_t[:, None, :] <= tidx[None, :, None]), axis=2
        ).astype(jnp.int32)  # (B, T)
        # secondary metric (plotting_node.py:195-218) + divergence latch,
        # same semantics as the scan path's per-tick guard
        d = jnp.linalg.norm(
            est_c[:, :, :2] - st_c["poses_true"][:, :, :2], axis=-1
        )
        return graphs, m_at, jnp.mean(d, axis=1), jnp.max(d, axis=1)

    rep_fns: dict = {}

    def make_rep_fn(cap: int):
        """Replay function specialized on a graph-prefix capacity `cap`:
        tick t only involves graph rows <= t, so ticks in [0, cap) can run
        on tensors sliced to cap rows — the per-tick PCG matvec cost is
        O(cap*K), not O(T*K), which roughly halves a full replay (average
        active prefix is T/2). Equivalent up to fp reduction-order (~1e-5
        on final metrics): all factor rows >= cap are invalid at those
        ticks and all pose nodes >= cap+1 are inactive (masked), and every
        pose row is re-seeded from poses_init when its own tick is
        replayed. Returns/accepts the FULL (T+1, 3) solution array."""

        def run(s, tk, p_full, l, m):
            s_c = s.replace(
                poses_init=s.poses_init[: cap + 1],
                poses_sol=s.poses_sol[: cap + 1],
                odom=s.odom[:cap],
                odom_valid=s.odom_valid[:cap],
                meas_rb=s.meas_rb[:cap],
                meas_lm=s.meas_lm[:cap],
                meas_valid=s.meas_valid[:cap],
            )
            p_c, l_c = posegraph.replay_iterative(
                cfg, s_c, tk, p_full[: cap + 1], l, m[:cap]
            )
            return jnp.concatenate([p_c, p_full[cap + 1:]], axis=0), l_c

        return jax.jit(jax.vmap(run, in_axes=(0, None, 0, 0, 0)))

    def replay_chunk(graphs_c, m_at_c):
        """Iterative mode: re-enact the per-tick incremental solves on the
        assembled graphs (posegraph.replay_iterative), one device call per
        graph-prefix-capacity window (see make_rep_fn)."""
        t_live = t_total - 1
        p_sol, l_sol = graphs_c.poses_sol, graphs_c.lms_sol
        cap_step = REPLAY_CAP_STEP
        i = 0
        while i < t_live:
            # prefix capacity for this window (quantized so only a few
            # shapes ever compile); the window ends at the cap
            cap = min(-(-(i + 1) // cap_step) * cap_step, t_live + 1)
            j = min(cap, t_live)
            fn = rep_fns.get((j - i, cap))
            if fn is None:
                fn = make_rep_fn(cap)
                rep_fns[(j - i, cap)] = fn
            p_sol, l_sol = fn(
                graphs_c, jnp.arange(i, j, dtype=jnp.int32),
                p_sol, l_sol, m_at_c,
            )
            jax.block_until_ready(p_sol)
            _vlog(f"replay ticks {i}..{j} cap={cap}")
            i = j
        g2 = graphs_c.replace(poses_sol=p_sol, lms_sol=l_sol)
        # the scan path runs solve_iteration on the final (non-live) tick
        # too, re-seeding node T-1 from poses_init and re-solving once
        fn = rep_fns.get("final")
        if fn is None:
            fn = jax.jit(
                jax.vmap(
                    lambda s: posegraph.solve_iteration(
                        cfg, s, s.M, node_t=jnp.int32(t_total - 1)
                    )
                )
            )
            rep_fns["final"] = fn
        out = jax.block_until_ready(fn(g2))
        _vlog("replay final solve done")
        return out

    err_sec_parts, max_sec_parts = [], []
    err_pg_parts, err_pgi_parts = [], []
    for i in range(0, batch, world_chunk):
        lms_c = lms_all[i: i + world_chunk]
        keys_c = keys[i: i + world_chunk]
        cmds_c, st_c = gen_chunk(lms_c, keys_c)
        if secondary == "naive":
            est_c = jax.jit(jax.vmap(lambda c: naive_deadreckon(cfg, c)))(
                cmds_c
            )
        else:
            out = rollout(
                cfg, lms_c, cmds_c, st_c["noise_u"], emit_traj=True,
                filter_kind="iekf" if secondary == "iekf_slam" else "ekf",
            )
            est_c = out["est_traj"]
        graphs_c, m_at_c, err_sec_c, max_sec_c = assemble_chunk(
            est_c, st_c, cmds_c
        )
        if iterative:
            graphs_c = replay_chunk(graphs_c, m_at_c)
        # solve this chunk while its graph tensors are still device-resident
        # and read back ONLY the per-world metric vectors
        err_pg_c, err_pgi_c = _pg_bulk_solve(
            cfg, graphs_c, st_c["poses_true"], lms_c.shape[0], solve_chunk
        )
        err_pg_parts.append(err_pg_c)
        err_pgi_parts.append(err_pgi_c)
        err_sec_parts.append(np.asarray(err_sec_c))
        max_sec_parts.append(np.asarray(max_sec_c))
        _vlog(f"worlds {i}..{i + lms_c.shape[0]}: done")

    err_sec = np.concatenate(err_sec_parts)
    max_sec = np.concatenate(max_sec_parts)

    results = {
        "err_" + secondary: err_sec,
        "diverged_" + secondary: ~np.isfinite(max_sec)
        | (max_sec > DIVERGENCE_RADIUS),
    }
    err_pg = np.concatenate(err_pg_parts)
    err_pg_init = np.concatenate(err_pgi_parts)
    results["err_pose_graph_result"] = err_pg
    results["err_pose_graph_initial"] = err_pg_init
    results["err_pose_graph"] = err_pg
    results["diverged_pose_graph"] = results["diverged_" + secondary]
    # graph tensors never leave the device; callers only consume `results`
    return results, None, None


def _pg_bulk_solve(cfg: Config, primary, true_poses, batch, solve_chunk=8):
    """Final bulk solve + metrics over a batched PoseGraphState (shared by
    the scan-accumulated and streams-assembled paths). Returns per-world
    (err_pose_graph_result, err_pose_graph_initial) arrays."""
    t_total = cfg.num_iterations
    warm = cfg.pose_graph.solve_graph_every_iteration
    if cfg.pose_graph.solver == "schur":
        # O(T)-per-iteration Schur/block-Thomas PCG-GN: big chunks, GN
        # iterations in segments of seg_gn. Each segment is one
        # solve_schur_pcg call, which restarts its Levenberg damping, so the
        # segment length is part of the solver's schedule (the metrics the
        # tests and docs/ record were taken with seg_gn = 10). Warm-started
        # from the per-tick feedback in iterative mode
        # (pose_graph.cpp:262-267).
        pgc = cfg.pose_graph
        seg_gn = 10
        # cold starts: the same 16x/4x/1x graduated schedule as
        # posegraph.solve(), with identical per-stage iteration counts.
        # Warm starts (iterative mode) differ from
        # finalize() BY DESIGN: finalize graduates the warm iterate
        # itself, while here the warm iterate gets a 1x polish and a
        # separate graduated-from-raw-seeds retry runs as the rescue for
        # warm starts stuck in a bad minimum (take the lower-residual of
        # the two below) — same robustness, one extra compiled schedule
        # instead of three. meas_scale is a traced argument, so only the
        # distinct segment LENGTHS compile.
        stage_gn = max(8, pgc.bulk_gn_iters // 3)

        def segs(total):
            lens = [seg_gn] * (total // seg_gn)
            if total % seg_gn:
                lens.append(total % seg_gn)
            return lens

        graduated = (
            [(16.0, n) for n in segs(stage_gn)]
            + [(4.0, n) for n in segs(stage_gn)]
            + [(1.0, n) for n in segs(pgc.bulk_gn_iters)]
        )
        schedule = (
            [(1.0, n) for n in segs(pgc.bulk_gn_iters)]
            if warm else graduated
        )
        seg_fns = {
            n: jax.jit(
                jax.vmap(
                    lambda s, p, l, sc, _n=n: posegraph.solve_schur_pcg(
                        cfg, s, p, l, n_gn=_n,
                        n_cg=pgc.bulk_cg_iters, meas_scale=sc,
                    ),
                    in_axes=(0, 0, 0, None),
                )
            )
            for n in {n for _, n in graduated}
        }
        solve_chunk = max(solve_chunk, min(batch, 64))

        def solve_sub(sub):
            p = sub.poses_sol if warm else sub.poses_init
            l = sub.lms_sol if warm else sub.lms_init
            for sc, n in schedule:
                p, l, e = seg_fns[n](sub, p, l, jnp.float32(sc))
                jax.block_until_ready(p)
            if warm:
                pr, lr = sub.poses_init, sub.lms_init
                for sc, n in graduated:
                    pr, lr, er = seg_fns[n](sub, pr, lr, jnp.float32(sc))
                    jax.block_until_ready(pr)
                take = (er < e)[:, None, None]
                p = jnp.where(take, pr, p)
            return p
    else:
        # dense LM reference path: O((3T+2N)^3) per world, small chunks
        if warm:
            solve_fn = jax.jit(
                jax.vmap(
                    lambda s: posegraph.solve(
                        cfg, s, poses0=s.poses_sol, lms0=s.lms_sol
                    )[:2]
                )
            )
        else:
            solve_fn = jax.jit(
                jax.vmap(lambda s: posegraph.solve(cfg, s)[:2])
            )

        def solve_sub(sub):
            return solve_fn(sub)[0]

    err_pg = []
    err_pg_init = []
    # graph nodes are 0..T-1: node 0 is the init pose and the LAST tick
    # adds no node (it solves instead — pose_graph.cpp:208-214, mirrored
    # by posegraph.update's live mask), so node t+1 pairs with the truth
    # after tick t for t = 0..T-2. Including the never-created node T
    # would add a bogus |final truth pose| term to every world's mean.
    for i in range(0, batch, solve_chunk):
        sub = jax.tree.map(lambda a: a[i: i + solve_chunk], primary)
        poses_sol = solve_sub(sub)
        _vlog(f"bulk solve {i}..{min(i + solve_chunk, batch)}/{batch}")
        est = poses_sol[:, 1: t_total, :2]
        tr = true_poses[i: i + solve_chunk, : t_total - 1, :2]
        err_pg.append(
            np.asarray(jnp.mean(jnp.linalg.norm(est - tr, axis=-1), axis=-1))
        )
        # MEASURED error of the actual seeded graph (the reference
        # publishes /state/pose_graph/initial as its own metric,
        # plotting_node.py:195-218 over the initial estimate): evaluate
        # the node values the graph was seeded with (secondary poses at
        # node-creation time), same alignment as the result metric.
        est_i = sub.poses_init[:, 1: t_total, :2]
        err_pg_init.append(
            np.asarray(
                jnp.mean(jnp.linalg.norm(est_i - tr, axis=-1), axis=-1)
            )
        )
    return np.concatenate(err_pg), np.concatenate(err_pg_init)
