"""Probe candidate reconstructions of the reference's unrecorded high-noise
profile.

The naive-only calibration in scripts/reference_parity.py pins ONE scalar
(equal scaling of V_00 and V_11) but the published data constrains more: the
reference's high-noise EKF means (0.9301 / 1.3966,
/root/reference/ekf_ws/src/base_pkg/data/ekf_high_noise_*/ekf.csv) sit FAR
below its naive means (2.2090 / 2.2772), while the equal-scale reconstruction
(s=9.075) yields a compat EKF at ~2.3-2.6 m — no better than naive. The
forward/angular *split* of the injected noise decides how much a weak-gain
compat EKF (assumed W = I2, filter.h:110-117) can correct: angular drift is
observable through many landmark sightings, saturated forward noise
(V_00*9 ~ d_max, clipped at sim_node.py:218) much less so.

This script measures (naive, ekf) mean error over a grid of
(fwd_scale, ang_scale) pairs to find profiles consistent with BOTH published
numbers. Pure CPU-friendly diagnostics (run with JAX_PLATFORMS=cpu; modest
world counts) — the winning profile gets a full-scale on-chip parity run.

Usage:
  JAX_PLATFORMS=cpu python scripts/noise_profile_probe.py \
      [--worlds 64] [--t 1000] [--out docs/noise_profile_probe.json]
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

from accuracy_matrix import HIGH_NOISE, log, robust_stats, run_config

# (name, fwd_scale, ang_scale, vw_swap) applied to params.yaml V_00=0.01 /
# V_11=0.001. vw_swap=True reproduces the shipped filter.h:110-117 bug
# (assumed V=(W00,W11), W=I2); vw_swap=False models the hypothesis that the
# published CSVs PREDATE that bug — a filter that reads the same params.yaml
# as the sim (assumed V = the scaled values, assumed W = (0.01, 0.01)).
CANDIDATES = [
    ("equal_9.075", 9.075, 9.075, True),   # the naive-calibrated equal scaling
    ("fwd10_ang10", 10.0, 10.0, True),     # operator typed "10x both"
    ("fwd10_only", 10.0, 1.0, True),       # operator scaled forward only
    ("ang_only_40", 1.0, 40.0, True),      # angular-dominant reconstructions:
    ("ang_only_70", 1.0, 70.0, True),      #   V_11*s with V_00 untouched
    ("ang_only_100", 1.0, 100.0, True),
    ("fwd5_ang50", 5.0, 50.0, True),       # mixed
    ("v11_eq_v00", 1.0, 10.0, True),       # operator set V_11 := V_00 (0.01)
    ("both_x100_ang", 10.0, 100.0, True),  # operator added a zero to each dial
    # pre-bug-filter hypothesis: swap OFF, other quirks unchanged
    ("noswap_equal_9.075", 9.075, 9.075, False),
    ("noswap_fwd10_ang10", 10.0, 10.0, False),
    ("noswap_v11_eq_v00", 1.0, 10.0, False),
]

REF_HIGH = {"naive": (2.2090, 2.2772), "ekf": (0.9301, 1.3966)}


def measure(base, fwd_s, ang_s, filt, worlds, seed, vw_swap=True):
    import dataclasses as dc

    from live_ekf_slam_tpu.config import CompatConfig

    compat = CompatConfig.all_on()
    if not vw_swap:
        compat = dc.replace(compat, noise_vw_swap=False)
    cfg = base.replace(filter=filt, compat=compat)
    cfg = cfg.replace(
        process_noise=dataclasses.replace(
            cfg.process_noise,
            V_00=HIGH_NOISE["V_00"] * fwd_s,
            V_11=HIGH_NOISE["V_11"] * ang_s,
        )
    )
    res, _ = run_config(cfg, worlds, min(worlds, 512), key_seed=seed,
                        impl="xla")
    return robust_stats(res["err_" + filt], res["diverged_" + filt])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, default=64)
    ap.add_argument("--t", type=int, default=1000)
    ap.add_argument("--out", default="docs/noise_profile_probe.json")
    args = ap.parse_args()
    if os.environ.get("JAX_PLATFORMS", "") == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")

    from live_ekf_slam_tpu.config import Config

    base = Config(num_iterations=args.t)
    out = {"t": args.t, "worlds": args.worlds, "reference_high": REF_HIGH,
           "candidates": {}}
    if os.path.exists(args.out):
        try:
            with open(args.out) as f:
                prev = json.load(f)
            if prev.get("t") == args.t and prev.get("worlds") == args.worlds:
                out["candidates"].update(prev.get("candidates", {}))
                log(f"resuming: {sorted(out['candidates'])} done")
        except Exception as e:
            log(f"resume skipped: {e}")

    for name, fwd_s, ang_s, vw_swap in CANDIDATES:
        if name in out["candidates"]:
            continue
        t0 = time.perf_counter()
        seed = zlib.crc32(name.encode()) % 100000
        naive = measure(base, fwd_s, ang_s, "naive", args.worlds, seed)
        ekf = measure(base, fwd_s, ang_s, "ekf_slam", args.worlds, seed + 1,
                      vw_swap=vw_swap)
        out["candidates"][name] = {
            "fwd_scale": fwd_s, "ang_scale": ang_s, "vw_swap": vw_swap,
            "naive": naive, "ekf": ekf,
            "wall_s": round(time.perf_counter() - t0, 1),
        }
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        log(f"[{name}] naive {naive['mean']} ekf {ekf['mean']} "
            f"({out['candidates'][name]['wall_s']}s)")

    log(f"wrote {args.out}")
    print(f"{'profile':>14} {'fwd_s':>6} {'ang_s':>6} {'naive':>8} {'ekf':>8}"
          f"   target naive~2.24 ekf~0.93-1.40")
    for name, c in out["candidates"].items():
        print(f"{name:>14} {c['fwd_scale']:>6} {c['ang_scale']:>6} "
              f"{c['naive']['mean']:>8} {c['ekf']['mean']:>8}")


if __name__ == "__main__":
    main()
