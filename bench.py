"""Headline benchmark: the Monte-Carlo EKF-SLAM rollout on one GPU.

Configuration: the reference's own benchmark setting (params.yaml:14-15,
69-71: num_iterations 1000, random 20-landmark maps, TSP-NN trajectories),
4096 independent worlds, each with its own map and trajectory. The timed
window is the whole rollout, noise generation included, ended by
block_until_ready: one warm-up run, then the median of BENCH_REPS runs.

    BENCH_IMPL    kernel (default; ops/ekf_rollout.cu) | xla (the models/
                  vmap(scan) path, eval/runner.py)
    BENCH_FILTER  ekf_slam (default) | iekf_slam | ukf_slam / ukf_loc /
                  naive (xla only) | closed_loop (igvc closed loop)
    BENCH_WORLDS, BENCH_STEPS, BENCH_REPS

Prints one JSON line: metric, value, unit, per-run times and the device it
ran on (platform, device_kind, device count). Needs a GPU; exits non-zero
elsewhere.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def device_info():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"bench.py measures the GPU; JAX found platform {dev.platform!r}"
        )
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def time_runs(run, reps):
    """Warm-up (compile) run, then `reps` timed runs; returns (seconds per
    run, warm-up seconds, last output)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(run(0))
    warm = time.perf_counter() - t0
    times = []
    for rep in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(run(rep + 1))
        times.append(time.perf_counter() - t0)
    return times, warm, out


def closed_loop_bench(batch, t_total, reps, device):
    """Closed-loop igvc benchmark: sim + EKF + device A* replans + pure
    pursuit, fully on device (igvc1.launch:2-5 + goal_pursuit_node.py:23-56).
    Reports steps/s/world and the device-A* cost per replan block."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from live_ekf_slam_tpu.config import preset
    from live_ekf_slam_tpu.eval.closed_loop import build_closed_loop_segmented
    from live_ekf_slam_tpu.planning import astar as d_astar
    from live_ekf_slam_tpu.sim import maps as sim_maps

    cfg = preset("igvc1", num_iterations=t_total)
    # 37 igvc barrels (sim_node.py:190); 16 measurement slots cover the
    # barrels simultaneously visible inside the 3 m / ±90° sensing cone.
    # A* bounds sized for the ~18-cell local plans the igvc loop issues;
    # astar_window=64 relaxes a cropped window, exact for in-window plans
    # (tests/test_planning.py).
    cfg = cfg.replace(
        num_landmark_slots=37, num_meas_slots=16,
        path_planning=dataclasses.replace(
            cfg.path_planning, astar_max_iters=128,
            local_astar_max_iters=64, path_capacity=128,
            astar_window=64),
    )
    period = cfg.path_planning.replan_period
    init_fn, seg_fn, n_blocks = build_closed_loop_segmented(cfg)
    occ = jnp.asarray(sim_maps.load_occ_map(cfg)[0])
    keys = jax.random.split(jax.random.PRNGKey(7), batch)

    def run(seed):
        carry = init_fn(jax.random.split(jax.random.PRNGKey(seed), batch))
        world_keys = jax.vmap(
            lambda k: jax.random.split(k, n_blocks * period).reshape(
                n_blocks, period, 2)
        )(keys)  # (B, n_blocks, period, 2)
        return seg_fn(carry, jnp.swapaxes(world_keys, 0, 1)).err_sum

    times, warm, err = time_runs(run, reps)
    log(f"closed-loop warm-up (compile + run) {warm:.3f}s")

    @jax.jit
    def plan_once(ests):
        def one(est):
            goal, ok = d_astar.local_planner(cfg, occ, est)
            path, valid, reached = d_astar.astar(cfg, occ, est[:2], goal)
            return path.sum() + valid.sum() + reached.sum() + ok
        return jax.vmap(one)(ests)

    ests = jnp.tile(jnp.array([0.0, -8.5, 0.0]), (batch, 1))
    astar_times, _, _ = time_runs(lambda _: plan_once(ests), 5)

    t_run = (t_total // period) * period
    elapsed = float(np.median(times))
    avg_err = float(np.nanmean(np.asarray(err) / t_run))
    if not np.isfinite(avg_err):
        raise SystemExit("closed-loop rollout produced non-finite errors")
    return {
        "metric": (
            f"closed-loop igvc sim+EKF+A*+pure-pursuit steps/sec/world at "
            f"{batch} worlds (T={t_run}, replan every {period}; mean "
            f"avg-pos-err {avg_err:.4f} m)"
        ),
        "value": t_run / elapsed,
        "unit": "steps/s/world",
        "run_s": times,
        "astar_ms_per_replan_block": float(np.median(astar_times)) * 1e3,
        "device": device,
    }


def rollout_bench(filt, impl, batch, t_total, reps, device):
    import jax
    import jax.numpy as jnp

    from live_ekf_slam_tpu.config import Config
    from live_ekf_slam_tpu.sim import maps as sim_maps
    from live_ekf_slam_tpu.sim.trajectory import generate_trajectory

    if impl not in ("kernel", "xla"):
        raise SystemExit(f"BENCH_IMPL={impl}: use kernel or xla")
    if impl == "kernel" and filt not in ("ekf_slam", "iekf_slam"):
        raise SystemExit(
            f"BENCH_FILTER={filt} has no fused rollout; set BENCH_IMPL=xla"
        )
    cfg = Config(num_iterations=t_total).replace(filter=filt)
    lms = jnp.asarray(sim_maps.random_landmarks_batched(
        cfg, np.random.default_rng(0), batch))
    cmds = jax.jit(jax.vmap(
        lambda l, k: generate_trajectory(cfg, l, l.shape[0], k)
    ))(lms, jax.random.split(jax.random.PRNGKey(1), batch))
    n_lm = lms.shape[1]

    if impl == "xla":
        from live_ekf_slam_tpu.eval.runner import init_carry, make_step

        step = make_step(cfg, collect="sums")

        @jax.jit
        def rollout(key):
            keys = jax.vmap(lambda k: jax.random.split(k, t_total))(
                jax.random.split(key, batch))
            carry = jax.vmap(lambda l: init_carry(cfg, l))(lms)
            final, _ = jax.lax.scan(
                lambda c, inp: jax.vmap(step)(c, inp), carry,
                (jnp.swapaxes(cmds, 0, 1), jnp.swapaxes(keys, 0, 1)),
            )
            return final.err_sum_primary
    else:
        from live_ekf_slam_tpu.ops import fused_rollout as fr

        kind = "iekf" if filt == "iekf_slam" else "ekf"

        @jax.jit
        def rollout(key):
            noise = fr.rollout_noise(key, batch, t_total, n_lm)
            return fr.fused_ekf_rollout(cfg, lms, cmds, noise,
                                        filter_kind=kind)["err_sum"]

    times, warm, err = time_runs(
        lambda i: rollout(jax.random.PRNGKey(100 + i)), reps)
    log(f"warm-up (compile + run) {warm:.3f}s; runs {times}")
    elapsed = float(np.median(times))
    avg_err = float(np.nanmean(np.asarray(err) / t_total))
    if not np.isfinite(avg_err):
        raise SystemExit("benchmark rollout produced non-finite errors")
    return {
        "metric": (
            f"sim+{filt} steps/sec/world at {batch} worlds (T={t_total}, "
            f"{impl}; mean avg-pos-err {avg_err:.4f} m)"
        ),
        "value": t_total / elapsed,
        "unit": "steps/s/world",
        "run_s": times,
        "device": device,
    }


def main():
    batch = int(os.environ.get("BENCH_WORLDS", "4096"))
    t_total = int(os.environ.get("BENCH_STEPS", "1000"))
    impl = os.environ.get("BENCH_IMPL", "kernel")
    filt = os.environ.get("BENCH_FILTER", "ekf_slam")
    reps = int(os.environ.get("BENCH_REPS", "5"))

    from live_ekf_slam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    device = device_info()
    if filt == "closed_loop":
        res = closed_loop_bench(batch, t_total, reps, device)
    else:
        res = rollout_bench(filt, impl, batch, t_total, reps, device)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
