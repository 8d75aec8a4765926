"""Command-line entry points — the reference's launch files as presets.

    python -m live_ekf_slam_tpu.cli filter_demo_live --filter ekf_slam
    python -m live_ekf_slam_tpu.cli filter_demo_results_only --filter ukf_slam
    python -m live_ekf_slam_tpu.cli igvc1
    python -m live_ekf_slam_tpu.cli monte_carlo --batch 256 --runs-dir data/run1
    python -m live_ekf_slam_tpu.cli bar_graphs --data-dir data --plots-dir plots

Mirrors base_pkg/launch/{sim_base,filter_demo_live,filter_demo_results_only,
igvc1}.launch with their positional-arg overrides (occ_map_img, landmark_map,
precompute_trajectory, use_local_planner, tight_control, timer_period,
plot_result_only), plus an existing params.yaml via --params.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _build_cfg(args):
    from live_ekf_slam_tpu.config import Config, load_config, preset

    base = load_config(args.params) if args.params else Config()
    cfg = preset(args.preset, base) if args.preset != "monte_carlo" else base
    over = {}
    if args.filter:
        over["filter"] = args.filter
    if args.landmark_map:
        over["landmark_map"] = args.landmark_map
    if args.occ_map_img:
        over["occ_map_img"] = args.occ_map_img
    if args.steps:
        over["num_iterations"] = args.steps
    if args.plot_result_only:
        over["plot_result_only"] = True
    if over:
        cfg = cfg.replace(**over)
    return cfg


def _frame_from_state(cfg, name, state, t, true_pose, est_pose, path=None):
    from live_ekf_slam_tpu.viz.live import Frame

    lm = cov = sig = None
    if name in ("ekf_slam", "iekf_slam", "ukf_slam", "ukf_loc"):
        m = int(state.M)
        # for iekf_slam P is expressed in right-invariant coordinates; the
        # ellipse rendering treats it as a world-frame covariance, which is
        # exact at identity error and a first-order approximation otherwise
        cov = np.asarray(state.P)
        ids = np.asarray(state.ids)[:m]
        base = 3 if name in ("ekf_slam", "iekf_slam") else 4
        xs = np.asarray(state.x)
        lm = np.array(
            [[ids[i], xs[base + 2 * i], xs[base + 2 * i + 1]] for i in range(m)]
        ) if m else np.zeros((0, 3))
        if hasattr(state, "X"):
            sig = np.asarray(state.X)
    return Frame(
        timestep=t,
        true_pose=np.asarray(true_pose),
        est_pose=np.asarray(est_pose),
        landmarks=lm,
        cov=cov,
        sigma_pts=sig,
        path=path,
    )


def populate_pg_frame(cfg, pg, t, fr):
    """Fill Frame.pg_initial / pg_result / pg_landmarks from a PoseGraphState.

    Shared by the sync demo loop, the async viewer producer, and
    scripts/capture_demo.py (plotting_node.py:444-455 panel semantics): the
    growing initial graph every tick, the per-tick solution when iterative
    mode keeps one, and — on the final tick — the full posegraph.finalize
    solve overriding both. Returns (timestep, n_landmarks) for the caller's
    measurement-connection handling (which differs per site).
    """
    import jax

    ts = int(pg.timestep)
    m = int(pg.M)
    fr.pg_initial = np.asarray(pg.poses_init)[: ts + 1]
    if m:
        fr.pg_landmarks = np.asarray(pg.lms_init)[:m]
    if cfg.pose_graph.solve_graph_every_iteration and bool(pg.solved):
        fr.pg_result = np.asarray(pg.poses_sol)[: ts + 1]
        if m:
            fr.pg_landmarks = np.asarray(pg.lms_sol)[:m]
    if t + 1 >= cfg.num_iterations:
        from live_ekf_slam_tpu.models import posegraph

        solved = jax.jit(lambda s: posegraph.finalize(cfg, s))(pg)
        fr.pg_result = np.asarray(solved.poses_sol)[: ts + 1]
        if m:
            fr.pg_landmarks = np.asarray(solved.lms_sol)[:m]
    return ts, m


def run_sim_base(cfg, seed=0, base_dir=None):
    """sim_base.launch semantics: simulator + plotter + goal pursuit, NO
    localization node (sim_base.launch:11-15 starts only sim_node,
    plotting_node, goal_pursuit_node). The viewer shows the true vehicle and
    landmark map; commands come from the precomputed TSP trajectory, or from
    clicked-goal pursuit driving on the true pose when
    precompute_trajectory=false."""
    import jax
    import jax.numpy as jnp

    from live_ekf_slam_tpu.sim import maps as sim_maps
    from live_ekf_slam_tpu.sim.trajectory import generate_trajectory
    from live_ekf_slam_tpu.sim.world import init_world, sim_step
    from live_ekf_slam_tpu.viz.live import Frame, LiveViewer

    rng = np.random.default_rng(seed)
    occ, color = sim_maps.load_occ_map(cfg)
    lms, n_active = sim_maps.make_landmarks(cfg, rng, occ)
    cfg = cfg.replace(num_landmark_slots=n_active, num_meas_slots=n_active)
    lms_j = jnp.asarray(lms)
    world = init_world(cfg, lms_j, n_active)
    step = jax.jit(lambda w, c, k: sim_step(cfg, w, c, k))

    gp = None
    if cfg.precompute_trajectory:
        cmds = generate_trajectory(cfg, lms_j, n_active, jax.random.PRNGKey(seed))
    else:
        from live_ekf_slam_tpu.eval.interactive import GoalPursuit

        gp = GoalPursuit(cfg, occ)
        gp._cur = list(cfg.init_pose)

    viewer = LiveViewer(
        cfg, color_map=color, true_landmarks=lms,
        on_goal=(gp.set_goal if gp is not None else None),
    )
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), cfg.num_iterations)
    cmd = jnp.zeros(2, jnp.float32)
    for t in range(cfg.num_iterations):
        if gp is None:
            cmd = cmds[t]
        world, _ = step(world, cmd, keys[t])
        tp = np.asarray(world.pose)
        if gp is not None:
            # goal pursuit drives on the only pose there is: the truth
            cmd = jnp.asarray(gp.on_state(tp), jnp.float32)
        frame = Frame(timestep=t + 1, true_pose=tp, est_pose=None)
        if gp is not None and gp.path is not None and len(gp.path):
            frame.path = np.asarray(gp.path)
        viewer.update(frame)
    viewer.finish(base_dir)


def run_demo(cfg, seed=0, live=True, base_dir=None):
    """filter_demo_{live,results_only}: one world, precomputed TSP trajectory,
    online filter, viewer."""
    import jax
    import jax.numpy as jnp

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

    # clicked-goal pursuit (goal_pursuit_node semantics) when the trajectory
    # is not precomputed; otherwise TSP replay (sim_node.py:55-60)
    gp = None
    if cfg.precompute_trajectory:
        cmds = generate_trajectory(
            cfg, lms_j, n_active, jax.random.PRNGKey(seed)
        )
    else:
        from live_ekf_slam_tpu.eval.interactive import GoalPursuit

        gp = GoalPursuit(cfg, occ)
        gp._cur = list(cfg.init_pose)

    viewer = LiveViewer(
        cfg, color_map=color, true_landmarks=lms,
        on_goal=(gp.set_goal if gp is not None else None),
    )
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), cfg.num_iterations)

    # async viewer feed: device stepping in a producer thread, rendering the
    # newest frame here (PlotterConfig.async_viz; native ring buffer).
    # Precomputed-trajectory, non-pose-graph demos only — interactive goal
    # pursuit needs the click/render thread in the control loop.
    from live_ekf_slam_tpu import native as les_native

    if (
        live and cfg.plotter.async_viz and gp is None
        and les_native.available()
    ):
        import threading
        import time as _time

        from live_ekf_slam_tpu.viz.async_feed import AsyncFrameFeed

        pg_mode = cfg.filter == "pose_graph"
        state_name = (
            cfg.pose_graph.filter_to_compare if pg_mode else cfg.filter
        )
        n = cfg.num_landmark_slots
        # frame layout sized to what this filter renders: covariance block,
        # UKF sigma-point block, pose-graph panel histories
        if state_name in ("ekf_slam", "iekf_slam"):
            d_cov = 3 + 2 * n
        elif state_name == "ukf_slam":
            d_cov = 4 + 2 * n
        elif state_name == "ukf_loc":
            d_cov = 4
        else:
            d_cov = 0
        du_sigma = d_cov if state_name.startswith("ukf") else 0
        feed = AsyncFrameFeed(
            n, d_cov=d_cov, du_sigma=du_sigma,
            t_pg=cfg.num_iterations if pg_mode else 0,
            n_pg_meas=(
                cfg.num_iterations * cfg.num_meas_slots
                if pg_mode and cfg.plotter.pg_show_meas_connections else 0
            ),
        )
        errors: list[float] = []
        done = threading.Event()

        producer_exc: list[BaseException] = []

        def producer():
            # done.set() must fire even if the rollout raises (e.g. a JAX
            # runtime error mid-run), or the render loop below spins forever
            # waiting on a producer that already died; the exception is
            # re-raised on the main thread after join
            try:
                c = carry
                pg_pairs: list[tuple[int, int]] = []
                for t in range(cfg.num_iterations):
                    c, (tp, ep) = step(c, (cmds[t], keys[t]))
                    tp_, ep_ = np.asarray(tp), np.asarray(ep)
                    errors.append(float(np.linalg.norm(ep_[:2] - tp_[:2])))
                    state = c.secondary if pg_mode else c.primary
                    fr = _frame_from_state(
                        cfg, state_name, state, t + 1, tp_, ep_
                    )
                    if pg_mode:
                        pg = c.primary
                        ts, m = populate_pg_frame(cfg, pg, t, fr)
                        if (
                            cfg.plotter.pg_show_meas_connections
                            and ts > 0 and m
                        ):
                            # newly-added row only (same O(T) accumulation
                            # as the sync path, cli sync branch below)
                            mv_row = np.asarray(pg.meas_valid[ts - 1])
                            ml_row = np.asarray(pg.meas_lm[ts - 1])
                            for kk in np.nonzero(mv_row)[0]:
                                pg_pairs.append((ts, int(ml_row[kk])))
                            if pg_pairs:
                                fr.pg_meas = np.asarray(pg_pairs, np.int64)
                    feed.push(fr)
            except BaseException as e:  # noqa: BLE001 - relayed to main
                producer_exc.append(e)
            finally:
                done.set()

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        while not done.is_set() or len(feed.ring):
            frame = feed.pop_latest()
            if frame is None:
                _time.sleep(0.005)
                continue
            viewer.update(frame)
        th.join()
        if producer_exc:
            feed.close()
            raise producer_exc[0]
        # the metric covers every tick (producer-side), not just rendered ones
        viewer.errors = errors
        avg = viewer.finish(base_dir)
        print(
            f"Average error in {cfg.filter} from true vehicle pose history = "
            f"{avg} (async viz: {feed.dropped} frames skipped)"
        )
        feed.close()
        return avg

    import jax.numpy as jnp2
    cmd = jnp2.zeros(2, jnp2.float32)
    pg_meas_acc: list[tuple[int, int]] = []  # host-side (pose, lm) pairs
    for t in range(cfg.num_iterations):
        if gp is None:
            cmd = cmds[t]
        carry, (tp, ep) = step(carry, (cmd, keys[t]))
        if gp is not None:
            cmd = jnp2.asarray(gp.on_state(np.asarray(ep)), jnp2.float32)
        if live or t + 1 >= cfg.num_iterations:
            name = cfg.filter
            state = carry.primary if name != "pose_graph" else carry.secondary
            state_name = (
                cfg.pose_graph.filter_to_compare
                if name == "pose_graph" else name
            )
            frame = _frame_from_state(
                cfg, state_name, state, t + 1, np.asarray(tp), np.asarray(ep)
            )
            if name == "pose_graph":
                pg = carry.primary
                ts, m = populate_pg_frame(cfg, pg, t, frame)
                if (
                    cfg.plotter.pg_show_meas_connections
                    and ts > 0 and m
                ):
                    if live:
                        # fetch only the newly-added row and accumulate the
                        # (pose, landmark) pairs host-side: re-reading the
                        # full (ts, K) tensors every tick is an O(T^2)
                        # device->host transfer pattern over the run
                        mv_row = np.asarray(pg.meas_valid[ts - 1])
                        ml_row = np.asarray(pg.meas_lm[ts - 1])
                        for kk in np.nonzero(mv_row)[0]:
                            pg_meas_acc.append((ts, int(ml_row[kk])))
                        if pg_meas_acc:
                            frame.pg_meas = np.asarray(pg_meas_acc, np.int64)
                    else:
                        # results-only mode renders one final frame: one
                        # full read is the O(T) path here
                        mv = np.asarray(pg.meas_valid)[:ts]
                        ml = np.asarray(pg.meas_lm)[:ts]
                        rows, cols = np.nonzero(mv)
                        frame.pg_meas = np.stack(
                            [rows + 1, ml[rows, cols]], axis=1
                        )
            viewer.update(frame)
    avg = viewer.finish(base_dir)
    print(f"Average error in {cfg.filter} from true vehicle pose history = {avg}")
    return avg


def run_igvc(cfg, seed=0, base_dir=None, batch=1):
    """igvc1: closed-loop local-planner run, fully on device."""
    import jax

    from live_ekf_slam_tpu.eval.closed_loop import run_closed_loop

    metrics, final, _ = run_closed_loop(
        cfg, jax.random.PRNGKey(seed), batch=batch
    )
    err = metrics["err_" + cfg.filter]
    print(
        f"igvc closed loop: avg position error {np.mean(err):.4f} m, "
        f"final true pose {metrics['final_true_pose'][0]}"
    )
    return metrics


def run_monte_carlo_cli(cfg, args):
    import jax

    from live_ekf_slam_tpu.eval.runner import run_monte_carlo
    from live_ekf_slam_tpu.eval.recorder import write_run_csvs

    collect = "poses" if cfg.filter == "pose_graph" else "sums"
    res, _, _ = run_monte_carlo(
        cfg, jax.random.PRNGKey(args.seed), batch=args.batch,
        seed=args.seed, collect=collect,
    )
    out = {k.replace("err_", ""): v for k, v in res.items()}
    for k, v in out.items():
        if k.startswith("diverged_"):
            print(f"{k}: {int(np.sum(v))} of {len(v)} worlds")
        else:
            print(f"{k}: mean {np.mean(v):.4f} std {np.std(v):.4f}")
    if args.runs_dir:
        write_run_csvs(args.runs_dir, out)
    return res


def main(argv=None):
    from live_ekf_slam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    p = argparse.ArgumentParser(prog="live_ekf_slam_tpu")
    p.add_argument(
        "preset",
        choices=[
            "sim_base", "filter_demo_live", "filter_demo_results_only",
            "igvc1", "monte_carlo", "bar_graphs",
        ],
    )
    p.add_argument("--params", help="reference-format params.yaml")
    p.add_argument("--filter", help="ekf_slam|iekf_slam|ukf_loc|ukf_slam|pose_graph|naive")
    p.add_argument("--landmark-map", dest="landmark_map")
    p.add_argument("--occ-map-img", dest="occ_map_img")
    p.add_argument("--steps", type=int)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--plot-result-only", action="store_true")
    p.add_argument("--runs-dir", help="CSV output dir (monte_carlo)")
    p.add_argument("--data-dir", default="data")
    p.add_argument("--plots-dir", default="plots/err_comparisons")
    p.add_argument("--base-dir", help="artifact dir for plots/data")
    args = p.parse_args(argv)

    if args.preset == "bar_graphs":
        from live_ekf_slam_tpu.eval.recorder import make_all_bar_charts

        make_all_bar_charts(args.data_dir, args.plots_dir)
        return 0

    cfg = _build_cfg(args)
    if args.preset == "monte_carlo":
        run_monte_carlo_cli(cfg, args)
    elif args.preset == "igvc1":
        run_igvc(cfg, seed=args.seed, base_dir=args.base_dir)
    elif args.preset == "sim_base":
        run_sim_base(cfg, seed=args.seed, base_dir=args.base_dir)
    elif args.preset == "filter_demo_live":
        run_demo(cfg, seed=args.seed, live=True, base_dir=args.base_dir)
    else:  # filter_demo_results_only
        run_demo(cfg, seed=args.seed, live=False, base_dir=args.base_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
