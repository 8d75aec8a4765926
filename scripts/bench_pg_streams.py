"""Throughput of the pose-graph streams path (sim + secondary + graph
assembly, and the bulk solve separately) at Monte-Carlo scale.

Usage: python scripts/bench_pg_streams.py [--worlds 1024] [--t 1000]
       [--secondary naive|ekf_slam] [--noise high|low]

Prints a JSON line with accumulation steps/s/world and solve wall time.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, default=1024)
    ap.add_argument("--t", type=int, default=1000)
    ap.add_argument("--secondary", default="naive")
    ap.add_argument("--noise", default="high")
    args = ap.parse_args()

    import dataclasses

    import jax

    from live_ekf_slam_tpu.config import Config
    from live_ekf_slam_tpu.eval import runner as R
    from live_ekf_slam_tpu.models import posegraph
    from live_ekf_slam_tpu.sim.streams import naive_deadreckon, sim_streams
    from live_ekf_slam_tpu.sim.trajectory import generate_trajectory

    from accuracy_matrix import HIGH_NOISE, LOW_NOISE, make_cfg  # noqa: E402

    base = Config(num_iterations=args.t)
    cfg = make_cfg(base, args.noise, "pose_graph",
                   secondary=args.secondary, iterative=False)
    cfg = cfg.replace(
        pose_graph=dataclasses.replace(
            cfg.pose_graph, solve_graph_every_iteration=False
        )
    )

    batch = args.worlds
    cfg, lms = R._gen_maps(cfg, np.random.default_rng(0), batch)
    keys = jax.random.split(jax.random.PRNGKey(1), batch)
    n_active = cfg.num_landmark_slots

    @jax.jit
    def accumulate(lms_b, keys_b):
        def one(l, k):
            k_traj, k_roll = jax.random.split(k)
            cmds = generate_trajectory(cfg, l, n_active, k_traj)
            st = sim_streams(cfg, l, n_active, cmds, k_roll)
            if args.secondary == "naive":
                est = naive_deadreckon(cfg, cmds)
            else:
                est = st["poses_true"]  # placeholder; EKF path timed apart
            g = posegraph.assemble_streams(
                cfg, est, st["r"], st["b"], st["vis"], cmds
            )
            return g, cmds, st["noise_u"], st["poses_true"]

        return jax.vmap(one)(lms_b, keys_b)

    t0 = time.perf_counter()
    g, cmds, noise_u, poses_true = accumulate(lms, keys)
    jax.block_until_ready(g.meas_rb)
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    g, cmds, noise_u, poses_true = accumulate(lms, keys)
    jax.block_until_ready(g.meas_rb)
    accum_s = time.perf_counter() - t0

    ekf_s = 0.0
    if args.secondary == "ekf_slam":
        from live_ekf_slam_tpu.ops.fused_rollout import fused_ekf_rollout

        out = fused_ekf_rollout(cfg, lms, cmds, noise_u, emit_traj=True)
        jax.block_until_ready(out["est_traj"])  # compile
        t0 = time.perf_counter()
        out = fused_ekf_rollout(cfg, lms, cmds, noise_u, emit_traj=True)
        jax.block_until_ready(out["est_traj"])
        ekf_s = time.perf_counter() - t0

    total_accum = accum_s + ekf_s
    sps_world = args.t / total_accum

    t0 = time.perf_counter()
    err_pg, err_init = R._pg_bulk_solve(
        cfg, g, poses_true, batch, solve_chunk=64
    )
    solve_s = time.perf_counter() - t0

    print(json.dumps({
        "metric": (
            f"pg-streams accumulation steps/s/world, {batch} worlds, "
            f"T={args.t}, secondary={args.secondary}, {args.noise} noise"
        ),
        "value": round(sps_world, 1),
        "unit": "steps/s/world",
        "accum_wall_s": round(total_accum, 2),
        "accum_warmup_s": round(warm, 1),
        "solve_wall_s": round(solve_s, 1),
        "pgs_mean_err": round(float(np.nanmean(err_pg)), 4),
        "pgs_init_mean_err": round(float(np.nanmean(err_init)), 4),
    }))


if __name__ == "__main__":
    main()
