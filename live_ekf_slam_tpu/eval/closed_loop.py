"""Closed-loop (igvc-style) runner: sim + filter + planner fused on device.

Replaces the goal_pursuit_node feedback loop (goal_pursuit_node.py:23-56):
every published filter state drives pure pursuit, and in local-planner mode
the path is re-planned every `replan_period` ticks (goal_pursuit_node.py:30).

Structure: replan ticks are batch-uniform (timestep % 5 == 0), so the run
is a scan over *blocks* — one device A* relaxation per block, then
`replan_period` control+sim+filter ticks — which keeps the expensive plan off
the per-tick path entirely instead of hiding it behind a lax.cond that vmap
would execute every tick anyway.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from live_ekf_slam_tpu.core import pytree as struct

from live_ekf_slam_tpu.config import Config
from live_ekf_slam_tpu.core.types import WorldState
from live_ekf_slam_tpu.eval import runner as _runner
from live_ekf_slam_tpu.planning import astar as d_astar
from live_ekf_slam_tpu.planning import pure_pursuit as pp
from live_ekf_slam_tpu.sim import maps as sim_maps
from live_ekf_slam_tpu.sim.world import init_world, sim_step


@struct.dataclass
class ClosedLoopCarry:
    world: WorldState
    filt: object
    pursuit: pp.PursuitState
    cmd: jnp.ndarray          # command to apply next tick
    err_sum: jnp.ndarray
    timestep: jnp.ndarray


def make_block_step(cfg: Config, occ):
    """One block = (optional replan) + replan_period control ticks."""
    period = cfg.path_planning.replan_period
    name = cfg.filter
    use_pp = cfg.path_planning.nav_method == "pp"

    def control_tick(carry: ClosedLoopCarry, key):
        world, meas = sim_step(cfg, carry.world, carry.cmd, key)
        filt = _runner._filter_update(
            cfg, name, carry.filt, carry.cmd, meas, true_map=world.landmarks
        )
        est = _runner._filter_pose(name, filt)
        if use_pp:
            cmd, pursuit = pp.get_next_cmd(cfg, carry.pursuit, est)
        else:
            cmd, pursuit = pp.direct_nav(cfg, carry.pursuit, est)
        err = carry.err_sum + jnp.linalg.norm(est[:2] - world.pose[:2])
        return (
            ClosedLoopCarry(
                world=world,
                filt=filt,
                pursuit=pursuit,
                cmd=cmd,
                err_sum=err,
                timestep=carry.timestep + 1,
            ),
            (world.pose, est),
        )

    def block(carry: ClosedLoopCarry, keys):
        # replan once the filter has produced `period` states
        # (goal_pursuit_node.py:30: msg.timestep % 5 == 0)
        def do_replan(carry):
            est = _runner._filter_pose(name, carry.filt)
            goal, ok = d_astar.local_planner(cfg, occ, est)
            path, valid, reached = d_astar.astar(cfg, occ, est[:2], goal)
            pursuit = pp.set_path(carry.pursuit, path, valid & reached[None])
            # on failure keep the old path (reference logs a warning and
            # sends a zero command; zero cmd falls out of an empty path)
            pursuit = jax.tree.map(
                lambda new, old: jnp.where(ok & reached, new, old),
                pursuit,
                carry.pursuit,
            )
            return carry.replace(pursuit=pursuit)

        carry = jax.lax.cond(
            carry.timestep > 0, do_replan, lambda c: c, carry
        )
        carry, outs = jax.lax.scan(control_tick, carry, keys)
        return carry, outs

    return block


def build_closed_loop(cfg: Config, jit: bool = True):
    """Build a reusable batched closed-loop runner.

    Returns ``(fn, occ)`` where ``fn(keys) -> (final_carry, outs)`` for a
    ``(batch, 2)`` array of PRNG keys. The function is jitted ONCE, so
    benchmark repetitions and repeated Monte-Carlo calls reuse the compiled
    executable instead of re-tracing per call."""
    occ_np, _ = sim_maps.load_occ_map(cfg)
    occ = jnp.asarray(occ_np)
    lms, n_active = sim_maps.make_landmarks(cfg)
    lms = jnp.asarray(lms)

    period = cfg.path_planning.replan_period
    n_blocks = cfg.num_iterations // period
    block = make_block_step(cfg, occ)

    def one_world(key):
        world = init_world(cfg, lms, n_active)
        filt = _runner._filter_init(cfg, cfg.filter)
        carry = ClosedLoopCarry(
            world=world,
            filt=filt,
            pursuit=pp.init(cfg),
            cmd=jnp.zeros(2, jnp.float32),
            err_sum=jnp.float32(0.0),
            timestep=jnp.int32(0),
        )
        keys = jax.random.split(key, n_blocks * period).reshape(
            n_blocks, period, 2
        )
        final, outs = jax.lax.scan(block, carry, keys)
        return final, outs

    fn = jax.vmap(one_world)
    if jit:
        fn = jax.jit(fn)
    return fn, occ


def build_closed_loop_segmented(cfg: Config):
    """Segmented variant: the full igvc rollout (num_iterations /
    replan_period blocks, each a device A* relaxation plus `replan_period`
    sim+filter+control ticks) as a host loop over device calls. Returns
    ``(init_fn, seg_fn, n_blocks)`` where ``init_fn(keys)->carry`` builds
    the batched carry and ``seg_fn(carry, seg_keys)->carry`` advances
    ``seg_keys.shape[0]`` blocks."""
    occ_np, _ = sim_maps.load_occ_map(cfg)
    occ = jnp.asarray(occ_np)
    lms, n_active = sim_maps.make_landmarks(cfg)
    lms = jnp.asarray(lms)

    period = cfg.path_planning.replan_period
    n_blocks = cfg.num_iterations // period
    block = make_block_step(cfg, occ)

    @jax.jit
    def init_fn(keys):
        def one(key):
            world = init_world(cfg, lms, n_active)
            filt = _runner._filter_init(cfg, cfg.filter)
            return ClosedLoopCarry(
                world=world,
                filt=filt,
                pursuit=pp.init(cfg),
                cmd=jnp.zeros(2, jnp.float32),
                err_sum=jnp.float32(0.0),
                timestep=jnp.int32(0),
            )
        return jax.vmap(one)(keys)

    @jax.jit
    def seg_fn(carry, seg_keys):
        # seg_keys: (n_seg_blocks, batch, period, 2)
        def batched_block(c, keys_t):
            c, _ = jax.vmap(block)(c, keys_t)
            return c, None

        carry, _ = jax.lax.scan(batched_block, carry, seg_keys)
        return carry

    return init_fn, seg_fn, n_blocks


def run_closed_loop(
    cfg: Config,
    key,
    batch: int = 1,
    collect: bool = False,
    jit: bool = True,
):
    """Run the igvc preset end-to-end on device. Returns (metrics, carry, outs)."""
    fn, _ = build_closed_loop(cfg, jit=jit)
    final, outs = fn(jax.random.split(key, batch))
    period = cfg.path_planning.replan_period
    t_total = (cfg.num_iterations // period) * period
    metrics = {
        "err_" + cfg.filter: np.asarray(final.err_sum) / t_total,
        "final_true_pose": np.asarray(final.world.pose),
    }
    return metrics, final, (outs if collect else None)
