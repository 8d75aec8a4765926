"""Reference-magnitude parity run.

The reference's published CSVs (/root/reference/ekf_ws/src/base_pkg/data/,
metric plotting_node.py:195-218) were produced with an UNRECORDED noise
profile: params.yaml ships V=(0.01, 0.001) but the published naive-filter
baseline (2.21-2.28 m high noise, 0.24-0.27 m low) is ~8.5x the error that
profile yields. Since both sims inject uniform noise with half-width = the V
values (sim_node.py:215-217; sim/world.py:34-45) and the naive filter's error
is linear in that half-width, we can CALIBRATE a scalar s on (V_00, V_11)
against the published naive mean, then replay the full 8-config matrix under
`CompatConfig.all_on()` + the reference's weak (1.3, 1.3, 1.2) pose-0 prior
(pose_graph.cpp:83) and compare number-for-number.

Two calibrations, one per published noise regime:
  high: target naive = mean(2.2090, 2.2772) = 2.2431 m   (naive_high_*/*.csv)
  low:  target naive = mean(0.2440, 0.2699) = 0.2570 m   (naive_low_*/*.csv)
Note the repo's HIGH profile (params.yaml defaults) already yields ~0.26 m —
i.e. the reference's published "low noise" runs are consistent with the
CURRENT params.yaml values, and its "high noise" runs with ~8.5x that.

Under compat the filters' ASSUMED noise stays pinned at the V/W-swap values
(filter.h:110-117) no matter what the sim actually injects — faithful to the
reference runs, where the C++ filters always ran with V=diag(W)=(0.01, 0.01),
W=I2. --scale-w additionally scales the sensing half-widths (hypothesis B:
the operator turned BOTH dials); default keeps W at params.yaml values.

--profile picks WHICH process-noise dial the calibration turns:
  equal: V_00 and V_11 scaled together (hypothesis A). Matches the published
         naive baseline but leaves the compat EKF at ~2.3-2.6 m — no better
         than naive — while the reference published 0.93-1.40 m.
  ang:   V_11 only, V_00 fixed at params.yaml's 0.01 (hypothesis C: the
         operator set the angular dial equal to the forward one). The
         scripts/noise_profile_probe.py grid found this reproduces BOTH
         published high-noise anchors at s_ang=10 (naive 2.28 vs 2.21-2.28;
         EKF 1.02 vs 0.93-1.40), because angular drift is the component a
         weak-gain compat filter (assumed W=I2) can still correct from many
         landmark sightings, while saturated forward noise (V_00*9 ~ d_max,
         clipped at sim_node.py:218) is nearly unobservable to it. Default.

Usage:
  python scripts/reference_parity.py [--worlds 256] [--worlds-iter 128]
      [--t 1000] [--scale-w] [--profile ang|equal]
      [--out docs/reference_parity.json]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import zlib

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from accuracy_matrix import HIGH_NOISE, log, robust_stats, run_config

# Published per-config means (BASELINE.md table; each is the mean over the
# ~10 runs in the corresponding base_pkg/data/<config>/ CSV).
REFERENCE = {
    "ekf_slam_low_iter":      {"secondary": 0.1883, "pgs_initial": 0.1895, "pgs_result": 0.1802},
    "ekf_slam_low_one_time":  {"secondary": 0.2671, "pgs_initial": 0.2289, "pgs_result": 0.1807},
    "ekf_slam_high_iter":     {"secondary": 1.3966, "pgs_initial": None,   "pgs_result": 0.7294},
    "ekf_slam_high_one_time": {"secondary": 0.9301, "pgs_initial": 0.9226, "pgs_result": 0.6124},
    "naive_low_iter":         {"secondary": 0.2440, "pgs_initial": 0.1946, "pgs_result": 0.1904},
    "naive_low_one_time":     {"secondary": 0.2699, "pgs_initial": 0.2609, "pgs_result": 0.1924},
    "naive_high_iter":        {"secondary": 2.2090, "pgs_initial": None,   "pgs_result": 0.9998},
    "naive_high_one_time":    {"secondary": 2.2772, "pgs_initial": 2.2524, "pgs_result": 0.9265},
}
NAIVE_TARGET = {
    "high": (2.2090 + 2.2772) / 2.0,
    "low": (0.2440 + 0.2699) / 2.0,
}


def make_compat_cfg(base, v_scale, filter_name, secondary=None,
                    iterative=None, scale_w=False, profile="equal",
                    w_scale=None):
    """Config at scaled sim noise, full compat quirks, reference prior.

    ``w_scale`` (when not None) sets the sensing half-width multiplier
    INDEPENDENTLY of the process scale — the intermediate-W sweep that
    adjudicates between hypothesis C (W x1) and D (W x v_scale)."""
    from live_ekf_slam_tpu.config import CompatConfig

    cfg = base.replace(filter=filter_name, compat=CompatConfig.all_on())
    if w_scale is None:
        w_scale = v_scale if scale_w else 1.0
    fwd_scale = 1.0 if profile == "ang" else v_scale
    cfg = cfg.replace(
        process_noise=dataclasses.replace(
            cfg.process_noise,
            V_00=HIGH_NOISE["V_00"] * fwd_scale,
            V_11=HIGH_NOISE["V_11"] * v_scale,
        ),
        sensing_noise=dataclasses.replace(
            cfg.sensing_noise,
            W_00=HIGH_NOISE["W_00"] * w_scale,
            W_11=HIGH_NOISE["W_11"] * w_scale,
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


def measure_naive(base, v_scale, worlds, scale_w, profile="equal"):
    cfg = make_compat_cfg(base, v_scale, "naive", scale_w=scale_w,
                          profile=profile)
    res, _ = run_config(cfg, worlds, min(worlds, 512), key_seed=4242,
                        impl="xla")
    return robust_stats(res["err_naive"], res["diverged_naive"])


def calibrate(base, regime, worlds, scale_w, tol=0.03, max_iter=4,
              profile="equal"):
    """Secant search on the V-scale for the published naive baseline.

    Error is ~linear in the scale (uniform half-width), so this converges in
    1-2 refinements. Returns (scale, history)."""
    target = NAIVE_TARGET[regime]
    if regime == "low":
        s = 1.0
    else:
        s = 10.0 if profile == "ang" else 8.5  # linear-model initial guesses
    history = []
    for it in range(max_iter):
        st = measure_naive(base, s, worlds, scale_w, profile=profile)
        history.append({"scale": round(s, 4), **st})
        log(f"  calibrate[{regime}] s={s:.3f} -> naive {st['mean']} m "
            f"(target {target:.4f})")
        if not np.isfinite(st["mean"]) or st["n"] == 0:
            # every world diverged at this scale: back off instead of
            # propagating NaN through the secant update
            s *= 0.5
            continue
        if abs(st["mean"] - target) / target < tol:
            return s, history
        s = s * target / st["mean"]  # linear update
    # max_iter exhausted: the final extrapolated s was never measured —
    # return the MEASURED scale whose naive mean landed closest to target
    measured = [h for h in history if np.isfinite(h["mean"]) and h["n"] > 0]
    if not measured:
        raise RuntimeError(
            f"calibrate[{regime}]: no finite naive measurement at any scale "
            f"(history: {history})"
        )
    best = min(measured, key=lambda h: abs(h["mean"] - target))
    log(f"  calibrate[{regime}] exhausted {max_iter} iters; using best "
        f"measured s={best['scale']} (naive {best['mean']})")
    return best["scale"], history


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, default=256)
    ap.add_argument("--worlds-iter", type=int, default=128)
    ap.add_argument("--worlds-cal", type=int, default=256)
    ap.add_argument("--t", type=int, default=1000)
    ap.add_argument("--scale-w", action="store_true")
    ap.add_argument("--w-scale", type=float, default=None,
                    help="sensing half-width multiplier, independent of the "
                    "process scale (intermediate-W adjudication sweep "
                    "between hypothesis C [W x1] and D [W x10]); combine "
                    "with --only to restrict to the high-noise configs the "
                    "hypothesis concerns")
    ap.add_argument("--profile", choices=("equal", "ang"), default="ang",
                    help="which process-noise dial the high-noise "
                    "calibration turns (see module docstring); 'ang' is the "
                    "probe-selected reconstruction that reproduces both "
                    "published anchors")
    ap.add_argument("--solos-only", action="store_true",
                    help="calibration + solo filters only (the EKF solo is "
                    "the cheap discriminator between the W-fixed and "
                    "W-scaled reconstructions of the reference's unrecorded "
                    "high-noise profile)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--gn", type=int, default=None,
                    help="override PoseGraphConfig.bulk_gn_iters (the "
                    "default 50 underconverges at the hot profile; the "
                    "budget sweep in docs/pgs_budget_probe.json converges "
                    "by 150)")
    ap.add_argument("--cg", type=int, default=None,
                    help="override PoseGraphConfig.bulk_cg_iters")
    ap.add_argument("--only", default=None,
                    help="comma list restricting which PGS configs run "
                    "(e.g. 'naive_high_one_time,ekf_slam_high_iter')")
    ap.add_argument("--out", default="docs/reference_parity.json")
    args = ap.parse_args()
    if os.environ.get("JAX_PLATFORMS", "") == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
    if args.smoke:
        args.worlds = args.worlds_iter = args.worlds_cal = 8
        args.t = 60

    from live_ekf_slam_tpu.config import Config

    base = Config(num_iterations=args.t)
    out = {"t": args.t, "worlds": args.worlds, "scale_w": args.scale_w,
           "w_scale": args.w_scale,
           "profile": args.profile, "gn": args.gn, "cg": args.cg,
           "calibration": {}, "configs": {}}
    if os.path.exists(args.out) and not args.smoke:
        try:
            with open(args.out) as f:
                prev = json.load(f)
            if prev.get("t") == args.t and prev.get("worlds") == args.worlds \
                    and prev.get("scale_w") == args.scale_w \
                    and prev.get("w_scale") == args.w_scale \
                    and prev.get("gn") == args.gn \
                    and prev.get("cg") == args.cg \
                    and prev.get("profile", "equal") == args.profile:
                out["calibration"].update(prev.get("calibration", {}))
                out["configs"].update(prev.get("configs", {}))
                log(f"resuming: {sorted(out['configs'])} done")
            else:
                # different reconstruction hypothesis: keep the old evidence
                # under a profile-suffixed name instead of clobbering it
                old = prev.get("profile", "equal")
                dst = args.out.replace(".json", f"_{old}.json")
                # never clobber an earlier archive of the same profile: these
                # are expensive on-chip measurements, so pick a fresh name
                n = 2
                while os.path.exists(dst):
                    dst = args.out.replace(".json", f"_{old}{n}.json")
                    n += 1
                os.rename(args.out, dst)
                log(f"moved {old}-profile results to {dst}")
        except Exception as e:
            log(f"resume skipped: {e}")

    def save():
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)

    scales = {}
    for regime in ("high", "low"):
        if regime in out["calibration"]:
            scales[regime] = out["calibration"][regime]["scale"]
            continue
        log(f"[calibrate {regime}] target {NAIVE_TARGET[regime]:.4f} m")
        s, hist = calibrate(base, regime, args.worlds_cal, args.scale_w,
                            max_iter=2 if args.smoke else 4,
                            profile=args.profile)
        out["calibration"][regime] = {
            "scale": round(s, 4),
            "target_naive_m": round(NAIVE_TARGET[regime], 4),
            "history": hist,
        }
        scales[regime] = s
        save()

    # solo filters at the calibrated profiles (context columns: the published
    # EKF means validate the W hypothesis that calibration can't pin down)
    for filt, regime in (("naive", "high"), ("ekf_slam", "high"),
                         ("naive", "low"), ("ekf_slam", "low")):
        name = f"solo_{filt}_{regime}"
        if name in out["configs"]:
            continue
        cfg = make_compat_cfg(base, scales[regime], filt,
                              scale_w=args.scale_w, profile=args.profile,
                              w_scale=args.w_scale)
        t0 = time.perf_counter()
        log(f"[{name}] {args.worlds} worlds ...")
        res, timing = run_config(cfg, args.worlds, min(args.worlds, 512),
                                 key_seed=zlib.crc32(name.encode()) % 100000,
                                 impl="xla")
        out["configs"][name] = {
            filt: robust_stats(res["err_" + filt], res["diverged_" + filt]),
            "wall_s": round(time.perf_counter() - t0, 1),
            "timing": timing,
        }
        save()
        log(f"[{name}] {out['configs'][name]}")

    order = [] if args.solos_only else [
        ("naive", "high", "one_time"), ("ekf_slam", "high", "one_time"),
        ("naive", "high", "iter"), ("ekf_slam", "high", "iter"),
        ("naive", "low", "one_time"), ("ekf_slam", "low", "one_time"),
        ("naive", "low", "iter"), ("ekf_slam", "low", "iter"),
    ]
    only = set(args.only.split(",")) if args.only else None
    for secondary, regime, mode in order:
        name = f"{secondary}_{regime}_{mode}"
        if name in out["configs"] or (only is not None and name not in only):
            continue
        iterative = mode == "iter"
        worlds = args.worlds_iter if iterative else args.worlds
        cfg = make_compat_cfg(base, scales[regime], "pose_graph",
                              secondary=secondary, iterative=iterative,
                              scale_w=args.scale_w, profile=args.profile,
                              w_scale=args.w_scale)
        if args.gn is not None or args.cg is not None:
            pg = cfg.pose_graph
            cfg = cfg.replace(pose_graph=dataclasses.replace(
                pg,
                bulk_gn_iters=pg.bulk_gn_iters if args.gn is None else args.gn,
                bulk_cg_iters=pg.bulk_cg_iters if args.cg is None else args.cg))
        t0 = time.perf_counter()
        log(f"[{name}] {worlds} worlds ...")
        impl = "xla" if args.smoke else "streams"
        chunk = min(worlds, 128 if iterative else 256)
        res, timing = run_config(cfg, worlds, chunk,
                                 key_seed=zlib.crc32(name.encode()) % 100000,
                                 collect="poses", impl=impl)
        out["configs"][name] = {
            "timing": timing,
            "secondary": robust_stats(
                res["err_" + secondary], res["diverged_" + secondary]),
            "pgs_initial": robust_stats(
                res["err_pose_graph_initial"], res["diverged_" + secondary]),
            "pgs_result": robust_stats(
                res["err_pose_graph_result"], res["diverged_" + secondary]),
            "reference": REFERENCE[name],
            "wall_s": round(time.perf_counter() - t0, 1),
        }
        save()
        log(f"[{name}] {out['configs'][name]}")

    save()
    log(f"wrote {args.out}")

    # side-by-side markdown
    print("| Config | ref filter | repo filter | ref PGS-init | repo PGS-init"
          " | ref PGS-result | repo PGS-result |")
    print("|---|---|---|---|---|---|---|")
    for name, ref in REFERENCE.items():
        st = out["configs"].get(name)
        if st is None:
            continue

        def fmt(col, refv):
            r = "—" if refv is None else f"{refv:.3f}"
            return (f"{r} | {st[col]['mean']:.3f} ± {st[col]['ci95']:.3f}")

        print(f"| {name} | {fmt('secondary', ref['secondary'])} | "
              f"{fmt('pgs_initial', ref['pgs_initial'])} | "
              f"{fmt('pgs_result', ref['pgs_result'])} |")


if __name__ == "__main__":
    main()
