"""Capture demo imagery: drive the live viewer
headless through real rollouts and save GIF + final PNG per demo into
docs/images/, mirroring the reference README's recorded demos
(/root/reference/images/, README.md:18-28).

Demos: EKF-SLAM (landmark estimates + covariance ellipses), UKF-SLAM (sigma
points), pose-graph (initial vs solved graph panel alongside the live map).

Usage: [JAX_PLATFORMS=cpu] MPLBACKEND=Agg python scripts/capture_demo.py
           [--t 300] [--stride 5] [--out docs/images]
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def capture_one(cfg, seed, gif_path, png_path, stride):
    import jax
    import jax.numpy as jnp
    from PIL import Image

    from live_ekf_slam_tpu.cli import _frame_from_state
    from live_ekf_slam_tpu.eval import runner as R
    from live_ekf_slam_tpu.sim import maps as sim_maps
    from live_ekf_slam_tpu.sim.trajectory import generate_trajectory
    from live_ekf_slam_tpu.viz.live import LiveViewer

    rng = np.random.default_rng(seed)
    occ, color = sim_maps.load_occ_map(cfg)
    lms, n_active = sim_maps.make_landmarks(cfg, rng, occ)
    cfg = cfg.replace(num_landmark_slots=n_active, num_meas_slots=n_active)
    lms_j = jnp.asarray(lms)
    carry = R.init_carry(cfg, lms_j, n_active)
    step = jax.jit(R.make_step(cfg, collect="poses"))
    cmds = generate_trajectory(cfg, lms_j, n_active, jax.random.PRNGKey(seed))
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), cfg.num_iterations)

    viewer = LiveViewer(cfg, color_map=color, true_landmarks=lms[:n_active])
    pg_mode = cfg.filter == "pose_graph"
    state_name = cfg.pose_graph.filter_to_compare if pg_mode else cfg.filter

    frames = []
    c = carry
    for t in range(cfg.num_iterations):
        c, (tp, ep) = step(c, (cmds[t], keys[t]))
        tp_, ep_ = np.asarray(tp), np.asarray(ep)
        state = c.secondary if pg_mode else c.primary
        fr = _frame_from_state(cfg, state_name, state, t + 1, tp_, ep_)
        if pg_mode:
            from live_ekf_slam_tpu.cli import populate_pg_frame

            populate_pg_frame(cfg, c.primary, t, fr)
        viewer.update(fr)
        if t % stride == 0 or t + 1 >= cfg.num_iterations:
            viewer.fig.canvas.draw()
            buf = np.asarray(viewer.fig.canvas.buffer_rgba())
            frames.append(Image.fromarray(buf[..., :3]))
    # hold the final frame for a beat
    frames += [frames[-1]] * 5
    frames[0].save(
        gif_path, save_all=True, append_images=frames[1:], duration=80,
        loop=0, optimize=True,
    )
    viewer.fig.savefig(png_path, dpi=90)
    viewer.close()
    log(f"wrote {gif_path} ({os.path.getsize(gif_path)//1024} KiB), "
        f"{png_path}")


def capture_igvc(t_total, seed, gif_path, png_path, stride):
    """Closed-loop igvc demo (igvc1.launch:2-5 + goal_pursuit_node.py:23-56):
    device A* local replanning every 5 ticks + pure pursuit on the EKF pose,
    rendered with the planned-path + goal overlay the reference's plotter
    draws for /plan/path."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from PIL import Image

    from live_ekf_slam_tpu.cli import _frame_from_state
    from live_ekf_slam_tpu.config import preset
    from live_ekf_slam_tpu.eval.closed_loop import (
        ClosedLoopCarry, make_block_step)
    from live_ekf_slam_tpu.eval import runner as R
    from live_ekf_slam_tpu.sim import maps as sim_maps
    from live_ekf_slam_tpu.sim.world import init_world
    from live_ekf_slam_tpu.viz.live import LiveViewer

    cfg = preset("igvc1", num_iterations=t_total)
    cfg = cfg.replace(
        num_landmark_slots=37, num_meas_slots=12,
        path_planning=dataclasses.replace(
            cfg.path_planning, astar_max_iters=96,
            local_astar_max_iters=48, path_capacity=128),
    )
    occ, color = sim_maps.load_occ_map(cfg)
    lms, n_active = sim_maps.make_landmarks(cfg)
    lms_j = jnp.asarray(lms)
    period = cfg.path_planning.replan_period
    n_blocks = t_total // period
    block = jax.jit(make_block_step(cfg, jnp.asarray(occ)))

    from live_ekf_slam_tpu.planning import pure_pursuit as pp

    carry = ClosedLoopCarry(
        world=init_world(cfg, lms_j, n_active),
        filt=R._filter_init(cfg, cfg.filter),
        pursuit=pp.init(cfg),
        cmd=jnp.zeros(2, jnp.float32),
        err_sum=jnp.float32(0.0),
        timestep=jnp.int32(0),
    )
    keys = jax.random.split(
        jax.random.PRNGKey(seed), n_blocks * period
    ).reshape(n_blocks, period, 2)

    viewer = LiveViewer(cfg, color_map=color, true_landmarks=lms[:n_active])
    frames = []
    t = 0
    for b in range(n_blocks):
        carry, (tp, ep) = block(carry, keys[b])
        tp_, ep_ = np.asarray(tp), np.asarray(ep)
        head = int(carry.pursuit.head)
        length = int(carry.pursuit.length)
        path = np.asarray(carry.pursuit.path)[head: head + length]
        for i in range(period):
            t += 1
            fr = _frame_from_state(
                cfg, cfg.filter, carry.filt,
                t, tp_[i], ep_[i], path=path if len(path) else None,
            )
            viewer.update(fr)
            if (t - 1) % stride == 0 or t >= t_total:
                viewer.fig.canvas.draw()
                buf = np.asarray(viewer.fig.canvas.buffer_rgba())
                frames.append(Image.fromarray(buf[..., :3]))
    frames += [frames[-1]] * 5
    frames[0].save(
        gif_path, save_all=True, append_images=frames[1:], duration=80,
        loop=0, optimize=True,
    )
    viewer.fig.savefig(png_path, dpi=90)
    viewer.close()
    log(f"wrote {gif_path} ({os.path.getsize(gif_path)//1024} KiB), "
        f"{png_path}")


def main():
    if os.environ.get("JAX_PLATFORMS", "") == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser()
    ap.add_argument("--t", type=int, default=300)
    ap.add_argument("--stride", type=int, default=5)
    ap.add_argument("--out", default="docs/images")
    ap.add_argument("--only", default=None,
                    help="comma list of demo names (default: all)")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    only = set(args.only.split(",")) if args.only else None

    import dataclasses

    from live_ekf_slam_tpu.config import Config

    base = Config(num_iterations=args.t)
    demos = {
        "ekf_demo": base.replace(filter="ekf_slam"),
        "ukf_demo": base.replace(filter="ukf_slam"),
        "pose_graph_demo": base.replace(
            filter="pose_graph",
            pose_graph=dataclasses.replace(
                base.pose_graph,
                filter_to_compare="ekf_slam",
                solve_graph_every_iteration=True,
            ),
            plotter=dataclasses.replace(
                base.plotter, pg_show_normal_viz_alongside=True
            ),
        ),
    }
    for name, cfg in demos.items():
        if only is not None and name not in only:
            continue
        log(f"[{name}] T={args.t} ...")
        capture_one(
            cfg, seed=3,
            gif_path=os.path.join(args.out, f"{name}.gif"),
            png_path=os.path.join(args.out, f"{name}_final.png"),
            stride=args.stride,
        )
    if only is None or "igvc_demo" in only:
        log(f"[igvc_demo] T={args.t} closed loop ...")
        capture_igvc(
            args.t, seed=3,
            gif_path=os.path.join(args.out, "igvc_demo.gif"),
            png_path=os.path.join(args.out, "igvc_demo_final.png"),
            stride=args.stride,
        )


if __name__ == "__main__":
    main()
