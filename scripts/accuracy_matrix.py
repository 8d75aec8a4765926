"""Full 8-config accuracy matrix at scale (BASELINE.md's table shape).

Runs the reference's benchmark matrix — {naive, EKF} secondary x {low, high}
noise x {iterative, one-time} pose-graph solve — plus the standalone filter
table, each over many Monte-Carlo worlds (vs the reference's ~10 repeated
runs per config, base_pkg/data/*.csv). Writes docs/accuracy_matrix.json and
prints a markdown table.

Usage:
  python scripts/accuracy_matrix.py --worlds 1024 --worlds-iter 256 \
      [--t 1000] [--smoke]
"""

from __future__ import annotations

import argparse
import os
import sys
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import dataclasses
import json
import sys
import time

import numpy as np


LOW_NOISE = dict(V_00=0.0004, V_11=7.615435494667714e-05,
                 W_00=0.01, W_11=0.00030461741978670857)
HIGH_NOISE = dict(V_00=0.01, V_11=0.001, W_00=0.01, W_11=0.01)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_cfg(base, noise, filter_name, secondary=None, iterative=None):
    from live_ekf_slam_tpu.config import Config  # noqa: F401

    cfg = base.replace(filter=filter_name)
    prof = LOW_NOISE if noise == "low" else HIGH_NOISE
    cfg = cfg.replace(
        process_noise=dataclasses.replace(
            cfg.process_noise, V_00=prof["V_00"], V_11=prof["V_11"]
        ),
        sensing_noise=dataclasses.replace(
            cfg.sensing_noise, W_00=prof["W_00"], W_11=prof["W_11"]
        ),
    )
    if filter_name == "pose_graph":
        cfg = cfg.replace(
            pose_graph=dataclasses.replace(
                cfg.pose_graph,
                filter_to_compare=secondary,
                solve_graph_every_iteration=iterative,
            )
        )
    return cfg


def robust_stats(err, diverged):
    ok = ~diverged & np.isfinite(err)
    vals = err[ok]
    n = len(vals)
    mean = float(vals.mean()) if n else float("nan")
    ci = float(1.96 * vals.std() / max(np.sqrt(n), 1)) if n else float("nan")
    return {
        "mean": round(mean, 4),
        "ci95": round(ci, 4),
        "median": round(float(np.median(vals)), 4) if n else None,
        "n": int(n),
        "diverged": int(diverged.sum()),
    }


def run_config(cfg, worlds, batch_chunk, key_seed, collect="sums",
               impl="xla"):
    import jax

    from live_ekf_slam_tpu.eval.runner import (
        run_monte_carlo,
        run_monte_carlo_pg_streams,
    )

    accum = {}
    chunk_s = []
    chunk_b = []
    for i in range(0, worlds, batch_chunk):
        b = min(batch_chunk, worlds - i)
        t_chunk0 = time.perf_counter()
        if impl == "streams":
            res, _, _ = run_monte_carlo_pg_streams(
                cfg, jax.random.PRNGKey(key_seed + i), b, seed=key_seed + i,
            )
        else:
            res, _, _ = run_monte_carlo(
                cfg, jax.random.PRNGKey(key_seed + i), b,
                seed=key_seed + i, collect=collect, impl=impl,
            )
        for k, v in res.items():
            accum.setdefault(k, []).append(np.asarray(v))
        chunk_s.append(round(time.perf_counter() - t_chunk0, 1))
        chunk_b.append(b)
        log(f"    {i + b}/{worlds} worlds ({chunk_s[-1]:.1f}s)")
    out = {k: np.concatenate(v) for k, v in accum.items()}
    # compile-vs-exec split: same-shape chunks reuse the
    # jit cache, so chunk 0 = compile + exec and later SAME-SIZE chunks are
    # exec only. A ragged last chunk recompiles (different batch shape), so
    # it is excluded from the exec median; the estimate is clamped at 0
    # (timing noise can put the median above chunk 0 on fast configs).
    timing = {"chunk_s": chunk_s}
    warm = [t for t, b in zip(chunk_s[1:], chunk_b[1:]) if b == chunk_b[0]]
    if warm:
        exec_s = float(np.median(warm))
        timing["exec_s_per_chunk"] = round(exec_s, 1)
        timing["compile_s_est"] = round(max(chunk_s[0] - exec_s, 0.0), 1)
    return out, timing


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, default=1024)
    ap.add_argument("--worlds-iter", type=int, default=256)
    ap.add_argument("--t", type=int, default=1000)
    ap.add_argument("--batch-chunk", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes to validate the harness")
    ap.add_argument("--fresh", action="store_true",
                    help="ignore any existing output file (no resume)")
    ap.add_argument("--out", default="docs/accuracy_matrix.json")
    args = ap.parse_args()
    if args.smoke:
        args.worlds, args.worlds_iter, args.t = 8, 8, 60
        args.batch_chunk = 8

    from live_ekf_slam_tpu.config import Config

    base = Config(num_iterations=args.t)
    out = {"t": args.t, "worlds": args.worlds,
           "worlds_iter": args.worlds_iter, "configs": {}}
    # resume: reuse configs already completed in an existing output file
    if os.path.exists(args.out) and not args.smoke and not args.fresh:
        try:
            with open(args.out) as f:
                prev = json.load(f)
            if prev.get("t") == args.t and prev.get("worlds") == args.worlds:
                out["configs"].update(prev.get("configs", {}))
                log(f"resuming: {sorted(out['configs'])} already done")
        except Exception as e:  # pragma: no cover - best-effort resume
            log(f"resume skipped: {e}")

    def save():
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)

    # ---- standalone filter table (default=high noise); the fused rollout
    # (CUDA kernel) carries ekf/iekf (parity-tested vs the XLA paths), naive
    # and the UKFs ride the XLA scan ----
    for filt, noise in (("naive", "high"), ("ekf_slam", "high"),
                        ("ukf_slam", "high"), ("ukf_loc", "high"),
                        ("ekf_slam", "low"), ("naive", "low"),
                        ("ukf_slam", "low"), ("ukf_loc", "low"),
                        # beyond-reference right-invariant EKF (models/iekf.py)
                        ("iekf_slam", "high"), ("iekf_slam", "low")):
        name = f"solo_{filt}_{noise}"
        if name in out["configs"]:
            continue
        cfg = make_cfg(base, noise, filt)
        if filt.startswith("ukf"):
            cfg = cfg.replace(
                ukf=dataclasses.replace(cfg.ukf, sigma_sqrt="chol")
            )
        # --smoke validates the harness off the GPU: the XLA path everywhere
        # (the published v2 iekf rows were produced on the XLA path).
        fused = filt in ("ekf_slam", "iekf_slam")
        impl = "fused" if fused and not args.smoke else "xla"
        t0 = time.perf_counter()
        log(f"[{name}] {args.worlds} worlds ...")
        chunk = args.batch_chunk if args.smoke else 512
        res, timing = run_config(
            cfg, args.worlds, chunk,
            key_seed=zlib.crc32(name.encode()) % 100000, impl=impl)
        out["configs"][name] = {
            filt: robust_stats(res["err_" + filt], res["diverged_" + filt]),
            "wall_s": round(time.perf_counter() - t0, 1),
            "timing": timing,
        }
        save()
        log(f"[{name}] {out['configs'][name]}")

    # ---- the 8 PGS configs (BASELINE.md table shape), ordered so the
    # highest-value rows land first if wall-clock runs out (high noise =
    # the reference's headline ordering; EKF-secondary = the rows round 1
    # left unreplicated) ----
    order = [
        ("naive", "high", "one_time"), ("ekf_slam", "high", "one_time"),
        ("naive", "high", "iter"), ("ekf_slam", "high", "iter"),
        ("naive", "low", "one_time"), ("ekf_slam", "low", "one_time"),
        ("naive", "low", "iter"), ("ekf_slam", "low", "iter"),
    ]
    for secondary, noise, mode in order:
        name = f"{secondary}_{noise}_{mode}"
        if name in out["configs"]:
            continue
        iterative = mode == "iter"
        worlds = args.worlds_iter if iterative else args.worlds
        cfg = make_cfg(base, noise, "pose_graph",
                       secondary=secondary, iterative=iterative)
        t0 = time.perf_counter()
        log(f"[{name}] {worlds} worlds ...")
        # all PGS configs ride the streams path (closed-form sim cumsums +
        # vectorized graph assembly, run_monte_carlo_pg_streams); iterative
        # mode re-enacts the per-tick incremental solves on the assembled
        # graphs (posegraph.replay_iterative — same solver calls as the
        # in-scan path). --smoke keeps the reference per-tick XLA scan.
        impl = "xla" if args.smoke else "streams"
        chunk = args.batch_chunk if args.smoke else (
            256 if iterative else 512)
        res, timing = run_config(
            cfg, worlds, chunk,
            key_seed=zlib.crc32(name.encode()) % 100000,
            collect="poses", impl=impl)
        cfgstats = {
            "timing": timing,
            "secondary": robust_stats(
                res["err_" + secondary], res["diverged_" + secondary]
            ),
            # MEASURED error of the seeded graph (runner evaluates the actual
            # poses_init node values; the reference's pose_graph_init.csv)
            "pgs_initial": robust_stats(
                res["err_pose_graph_initial"],
                res["diverged_" + secondary],
            ),
            "pgs_result": robust_stats(
                res["err_pose_graph_result"],
                res["diverged_" + secondary],
            ),
            "wall_s": round(time.perf_counter() - t0, 1),
        }
        out["configs"][name] = cfgstats
        save()
        log(f"[{name}] {cfgstats}")

    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    log(f"wrote {args.out}")

    # ---- markdown table ----
    print("| Config | secondary err (m) | PGS-result err (m) | diverged |")
    print("|---|---|---|---|")
    for name, st in out["configs"].items():
        if name.startswith("solo_"):
            continue
        sec = st["secondary"]
        pgs = st["pgs_result"]
        print(
            f"| {name} | {sec['mean']} ± {sec['ci95']} | "
            f"{pgs['mean']} ± {pgs['ci95']} | {sec['diverged']} |"
        )
    print()
    print("| Filter | err (m) | diverged |")
    print("|---|---|---|")
    for name, st in out["configs"].items():
        if not name.startswith("solo_"):
            continue
        # the filter key is everything between "solo_" and the noise suffix;
        # never key-order-dependent (st also holds wall_s and timing)
        k = name[len("solo_"):].rsplit("_", 1)[0]
        print(f"| {name} | {st[k]['mean']} ± {st[k]['ci95']} | {st[k]['diverged']} |")


if __name__ == "__main__":
    main()
