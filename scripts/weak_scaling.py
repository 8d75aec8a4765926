"""Weak-scaling benchmark for world-batch data parallelism over a mesh.

Holds worlds-per-device constant and grows the device count, timing the full
sim+EKF Monte-Carlo scan sharded with jax.sharding over a 1-D mesh
(parallel/mesh.py). The only cross-device communication is the final metric
all-reduce, so ideal weak scaling is flat time / linear aggregate throughput.

Two modes:
  * virtual (default): forces an n-device CPU mesh per measurement in a fresh
    subprocess (XLA_FLAGS=--xla_force_host_platform_device_count=n). This
    validates the sharded program end-to-end without accelerators. NOTE the
    virtual devices SHARE one host's cores, so wall-clock grows with total
    work — the honest signal here is that sharded execution works and that
    per-device work is independent, not the absolute scaling curve.
  * --real: uses the first n actual devices of the current backend (e.g. 1,
    2 and 4 GPUs of one host, NCCL all-reduce over NVLink).

Each device count runs in its own child process, one after the other, so at
most one process holds the accelerators at a time.

Usage:
  python scripts/weak_scaling.py --devices 1 2 4 8 --worlds-per-device 64 \
      --t 100 [--real] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def child(n: int, wpd: int, t: int, real: bool) -> None:
    if not real:
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={n}"
            ).strip()
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    import numpy as np

    from live_ekf_slam_tpu.config import Config
    from live_ekf_slam_tpu.eval import runner
    from live_ekf_slam_tpu.parallel import mesh as pmesh
    from live_ekf_slam_tpu.sim import maps as sim_maps
    from live_ekf_slam_tpu.sim.trajectory import generate_trajectory

    b = n * wpd
    cfg = Config(num_iterations=t, filter="ekf_slam")
    rng = np.random.default_rng(0)
    occ, _ = sim_maps.load_occ_map(cfg)
    lms = jnp.asarray(sim_maps.random_landmarks_batched(cfg, rng, b, occ=occ))
    keys = jax.random.split(jax.random.PRNGKey(0), b)
    step = runner.make_step(cfg, "sums")
    mesh = pmesh.make_mesh(n)
    sh = pmesh.world_sharding(mesh)

    @jax.jit
    def initfn(lms, keys):
        def one(l, k):
            k_traj, k_roll = jax.random.split(k)
            carry = runner.init_carry(cfg, l, l.shape[0])
            cmds = generate_trajectory(cfg, l, l.shape[0], k_traj)
            tick_keys = jax.random.split(k_roll, t)
            return carry, cmds, tick_keys
        return jax.vmap(one)(lms, keys)

    carry, cmds, tick_keys = initfn(lms, keys)
    carry = pmesh.shard_batch(carry, mesh)
    cmds = jax.device_put(cmds, sh)
    tick_keys = jax.device_put(tick_keys, sh)

    @jax.jit
    def rollout(carry, cmds, tick_keys):
        def batched(c, inp):
            return jax.vmap(step, in_axes=(0, (0, 0, None)))(c, inp)
        ticks = jnp.arange(cmds.shape[1], dtype=jnp.int32)
        final, _ = jax.lax.scan(
            batched, carry,
            (jnp.swapaxes(cmds, 0, 1), jnp.swapaxes(tick_keys, 0, 1), ticks),
        )
        # cross-device metric all-reduce (the run's only collective)
        return final, jnp.mean(final.err_sum_primary) / t

    final, mean_err = rollout(carry, cmds, tick_keys)
    jax.block_until_ready(mean_err)
    t0 = time.perf_counter()
    final, mean_err = rollout(carry, cmds, tick_keys)
    jax.block_until_ready(mean_err)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "devices": n,
        "worlds_per_device": wpd,
        "worlds": b,
        "t": t,
        "wall_s": round(dt, 4),
        "steps_per_s_per_world": round(t / dt, 1),
        "aggregate_ticks_per_s": round(t * b / dt, 1),
        "mean_err": float(mean_err),
        "backend": jax.default_backend(),
    }))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--worlds-per-device", type=int, default=64)
    ap.add_argument("--t", type=int, default=100)
    ap.add_argument("--real", action="store_true",
                    help="use the current backend's real devices")
    ap.add_argument("--out", default=None)
    ap.add_argument("--single", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.single is not None:
        child(args.single, args.worlds_per_device, args.t, args.real)
        return

    rows = []
    for n in args.devices:
        cmd = [sys.executable, os.path.abspath(__file__), "--single", str(n),
               "--worlds-per-device", str(args.worlds_per_device),
               "--t", str(args.t)]
        if args.real:
            cmd.append("--real")
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)  # child sets its own device count
        out = subprocess.run(cmd, capture_output=True, text=True, env=env)
        line = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
        if not line:
            print(f"devices={n}: FAILED\n{out.stderr[-2000:]}", file=sys.stderr)
            continue
        row = json.loads(line[-1])
        rows.append(row)
        print(f"devices={n}: {row}", file=sys.stderr)

    print("| devices | worlds | wall (s) | steps/s/world | aggregate ticks/s | mean err |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['devices']} | {r['worlds']} | {r['wall_s']} | "
              f"{r['steps_per_s_per_world']} | {r['aggregate_ticks_per_s']:.0f} | "
              f"{r['mean_err']:.4f} |")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"mode": "real" if args.real else "virtual-cpu",
                       "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
