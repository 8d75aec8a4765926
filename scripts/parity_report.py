"""Render docs/REFERENCE_PARITY.md from the measured parity JSONs.

Inputs (all produced on-chip by scripts/reference_parity.py,
scripts/pgs_budget_probe.py and scripts/noise_profile_probe.py):
  docs/reference_parity.json        — hypothesis C (V_11 x10, W x1), 12 configs
  docs/reference_parity_d.json      — hypothesis D (V_11 x10, W x10), high rows
  docs/reference_parity_equal.json  — rejected hypothesis A (both V dials)
  docs/reference_parity_w.json      — rejected hypothesis B (V and W dials)
  docs/reference_runs_stats.json    — per-run stats of the published CSVs
  docs/pgs_convergence_d.json       — solver-budget convergence path under D

The reference's published numbers are the per-config means of
/root/reference/ekf_ws/src/base_pkg/data/<config>/*.csv (metric:
plotting_node.py:195-218, mean distance of the estimated trajectory from
truth). Its noise profile was never recorded; see reference_parity.py's
docstring for the reconstruction. This report adjudicates the candidate
reconstructions against ALL 22 published numbers, using each published
config's own 10-run spread (reference_runs_stats.json) as the dominant
uncertainty.

Usage: python scripts/parity_report.py [--out docs/REFERENCE_PARITY.md]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

ROWS = [
    "naive_high_one_time", "ekf_slam_high_one_time",
    "naive_high_iter", "ekf_slam_high_iter",
    "naive_low_one_time", "ekf_slam_low_one_time",
    "naive_low_iter", "ekf_slam_low_iter",
]
COLS = ("secondary", "pgs_initial", "pgs_result")
LOW_ROWS = [r for r in ROWS if "_low_" in r]


def load_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except OSError:
        return None


def pub_lookup(stats, name, col):
    """Published per-run stats entry for (config, column), or None."""
    key = (name.replace("ekf_slam", "ekf")
           .replace("_high_", "_high_noise_")
           .replace("_low_", "_low_noise_"))
    entry = stats.get(key, {})
    if col == "secondary":
        csv = "naive.csv" if name.startswith("naive") else "ekf.csv"
    elif col == "pgs_result":
        csv = "pose_graph_result.csv"
    else:
        csv = ("pose_graph_init.csv" if "pose_graph_init.csv" in entry
               else "i_pgs_old.csv" if "i_pgs_old.csv" in entry else None)
    return entry.get(csv) if csv else None


def scorecard(cfgs, stats):
    """Score a hypothesis' measured configs against all published numbers.

    Returns a list of dicts, one per published number that the hypothesis
    has a measurement for: published mean/ci95 (10-run), repo mean/ci95
    (Monte-Carlo), combined-CI containment, relative error."""
    rows = []
    for name in ROWS:
        st = cfgs.get(name)
        if st is None or "secondary" not in st:
            continue
        for col in COLS:
            # iter-mode published "initial" (i_pgs_old.csv) is a DIFFERENT
            # statistic: the reference feeds each solve back as the next
            # initial estimate (pose_graph.cpp:262-267), so its published
            # initial trails the result by one solve, while this repo's
            # pgs_initial is the seeded node values (secondary poses at
            # node-creation time). Excluded from the totals; shown ‡ in
            # the detail table.
            if name.endswith("_iter") and col == "pgs_initial":
                continue
            pub = pub_lookup(stats, name, col)
            if pub is None:
                continue
            m, ci = st[col]["mean"], st[col]["ci95"]
            comb = math.sqrt(pub["ci95"] ** 2 + ci ** 2)
            rows.append({
                "name": name, "col": col,
                "pub_mean": pub["mean"], "pub_ci": pub["ci95"],
                "mean": m, "ci": ci,
                "inside": abs(m - pub["mean"]) <= comb,
                "rel": (m - pub["mean"]) / pub["mean"],
                "shared": st.get("shared_with_c", False),
            })
    return rows


def summarize(rows):
    if not rows:
        return "—"
    inside = sum(r["inside"] for r in rows)
    close = sum(abs(r["rel"]) <= 0.25 for r in rows)
    med = sorted(abs(r["rel"]) for r in rows)[len(rows) // 2]
    return (f"{inside}/{len(rows)} inside the combined 95% CI, "
            f"{close}/{len(rows)} within 25%, median \\|rel\\| {med:.0%}")


def fmt_pair(ref, st, pub=None):
    r = "—" if ref is None else f"{ref:.3f}"
    if st is None:
        return f"{r} | (pending)"
    comb = st["ci95"] if pub is None else math.sqrt(
        pub["ci95"] ** 2 + st["ci95"] ** 2)
    inside = ref is not None and abs(st["mean"] - ref) <= comb
    mark = " ✓" if inside else ""
    return f"{r} | {st['mean']:.3f} ± {st['ci95']:.3f}{mark}"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default="docs/reference_parity.json")
    ap.add_argument("--out", default="docs/REFERENCE_PARITY.md")
    args = ap.parse_args()

    c_data = load_json(args.json)
    if c_data is None or c_data.get("profile") != "ang":
        sys.exit(f"{args.json} is not the ang-profile run")
    base_dir = os.path.dirname(args.json) or "."
    d_data = load_json(os.path.join(base_dir, "reference_parity_d.json"))
    stats = load_json(os.path.join(base_dir, "reference_runs_stats.json")) or {}

    cal = c_data["calibration"]
    c_cfgs = c_data["configs"]
    # Hypothesis D measured only the high-noise rows: at the calibrated low
    # scale of 1.0 the W dial is also x1, so C and D are THE SAME config at
    # low noise (make_compat_cfg: w_scale = v_scale when --scale-w) — the
    # low rows are one set of measurements shared by construction, not a
    # copy of convenience.
    d_cfgs = dict(d_data["configs"]) if d_data else {}
    d_low_shared = False
    if d_data and d_data.get("calibration", {}).get("low", {}).get(
            "scale") == 1.0:
        for name in LOW_ROWS:
            if name not in d_cfgs and name in c_cfgs:
                d_cfgs[name] = {**c_cfgs[name], "shared_with_c": True}
                d_low_shared = True

    c_score = scorecard(c_cfgs, stats)
    d_score = scorecard(d_cfgs, stats)

    # ---- The W-dial family: C (W ×1) and D (W ×10) are endpoints of a
    # one-parameter family; the interior points (w3x/w5x sweeps) complete
    # it. The ADOPTED reconstruction is the member that best fits all 20
    # scoreable published numbers; every headline section below renders
    # relative to it. Low-noise rows are W ×1 for every member (a hidden
    # low-noise W dial is excluded by measurement: W ×10 at low noise
    # drives the compat EKF solo to ~0.94 m vs the published 0.19–0.27),
    # so C's low rows are shared by construction, not copied.
    family = [("1 (C)", c_cfgs, c_data)]
    for wname, path in (("3", "reference_parity_w3x.json"),
                        ("5", "reference_parity_w5x.json")):
        fj = load_json(os.path.join(base_dir, path))
        if fj:
            cfgs_f = dict(fj["configs"])
            for nm in LOW_ROWS:
                if nm not in cfgs_f and nm in c_cfgs:
                    cfgs_f[nm] = {**c_cfgs[nm], "shared_with_c": True}
            family.append((wname, cfgs_f, fj))
    if d_data:
        family.append(("10 (D)", d_cfgs, d_data))
    scores = {n: scorecard(cf, stats) for n, cf, _ in family}

    def rank(sc):
        if not sc:
            return (-1, -1, -9)
        ins = sum(r["inside"] for r in sc)
        close = sum(abs(r["rel"]) <= 0.25 for r in sc)
        med = sorted(abs(r["rel"]) for r in sc)[len(sc) // 2]
        return (ins, close, -med)

    # Only members with the full high-noise sweep are adoption candidates.
    full = [f for f in family if len(scores[f[0]]) >= len(scores["1 (C)"])]
    adopted_name, adopted_cfgs, adopted_data = max(
        full, key=lambda f: rank(scores[f[0]]))
    adopted_score = scores[adopted_name]
    a_w = adopted_name.split()[0]          # "1" | "3" | "5" | "10"
    a_short = {"1 (C)": "hypothesis C (V_11 ×10, W ×1)",
               "10 (D)": "hypothesis D (V_11 ×10, W ×10)"}.get(
        adopted_name, f"V_11 ×10, W ×{a_w}")

    lines = []
    w = lines.append
    w("# Reference-magnitude parity\n")
    w("Number-for-number comparison against the only quantitative results "
      "the reference ships: the per-config means of its 8 published run "
      "directories (`base_pkg/data/<config>/*.csv`, metric defined at "
      "`plotting_node.py:195-218`). Every repo number below was measured "
      "at T=1000 with `CompatConfig.all_on()` (the "
      "reference's V/W swap, weak (1.3, 1.3, 1.2) prior, and all quirk "
      "flags) under the reconstructed noise profile.\n")
    if len(family) > 1:
        w(f"**Adopted reconstruction: {a_short}** — the operator scaled "
          "the angular process dial ×10 and both sensing half-width dials "
          f"×{a_w}. It is the best joint fit to all 20 scoreable published "
          f"numbers ({summarize(adopted_score)}; full family adjudication "
          "below). Its residuals concentrate in the naive-secondary "
          "pose-graph results, which the convergence-path probes show are "
          "consistent with the reference's LM stopping earlier from the "
          "poor naive initial than this repo's solver does (see 'What "
          "remains unexplained').\n")

    w("## The unrecorded noise profile\n")
    w("The reference's published CSVs were produced at a noise profile that "
      "was never committed (its `params.yaml` defaults give errors ~10x "
      "smaller). `scripts/noise_profile_probe.py` grid-searched which dial "
      "the operator turned, using the two published high-noise anchors "
      "(naive 2.21–2.28 m, EKF 0.93–1.40 m) as a first discriminator:\n")
    w("| Hypothesis | naive (target 2.21–2.28) | EKF (target 0.93–1.40) | "
      "anchor verdict |")
    w("|---|---|---|---|")
    eq = load_json(os.path.join(base_dir, "reference_parity_equal.json"))
    if eq:
        w(f"| A: both V dials ×9.08 | "
          f"{eq['configs']['solo_naive_high']['naive']['mean']:.2f} | "
          f"{eq['configs']['solo_ekf_slam_high']['ekf_slam']['mean']:.2f} | "
          f"rejected — EKF no better than naive |")
    wj = load_json(os.path.join(base_dir, "reference_parity_w.json"))
    if wj:
        w(f"| B: V and W dials ×9.08 | "
          f"{wj['configs']['solo_naive_high']['naive']['mean']:.2f} | "
          f"{wj['configs']['solo_ekf_slam_high']['ekf_slam']['mean']:.2f} | "
          f"rejected — EKF no better than naive |")
    def anchor_row(label, cfgs_f, bold):
        if ("solo_naive_high" not in cfgs_f
                or "solo_ekf_slam_high" not in cfgs_f):
            return
        b = "**" if bold else ""
        w(f"| {b}{label}{b} | "
          f"{cfgs_f['solo_naive_high']['naive']['mean']:.2f} | "
          f"{cfgs_f['solo_ekf_slam_high']['ekf_slam']['mean']:.2f} | "
          f"{b}passes both anchors{b} |")

    anchor_row(f"C: angular V dial only ×{cal['high']['scale']:.0f}",
               c_cfgs, adopted_name == "1 (C)")
    for wname, cfgs_f, _ in family:
        if wname in ("1 (C)", "10 (D)"):
            continue
        anchor_row(f"V_11 ×10 and W ×{wname}", cfgs_f,
                   adopted_name == wname)
    if d_data:
        anchor_row("D: V_11 ×10 and W ×10", d_cfgs,
                   adopted_name == "10 (D)")
    w("")
    w("A and B fail structurally: scaling the forward dial saturates "
      "against the sim's `d_max` clip (`sim_node.py:218`) and leaves the "
      "compat EKF (which assumes W=I₂) *no better than dead reckoning* — "
      "incompatible with the published 0.93–1.40 m. C and D both pass the "
      "two solo anchors (the naive filter never sees W, and the compat EKF "
      "ignores the true W by the V/W-overwrite quirk), so the anchors "
      "cannot separate them — but the pose-graph columns can, because "
      "through that same quirk (filter.h:110-117) the graph's between-"
      "factor sigmas ARE the sensing half-widths: scaling W loosens the "
      "between-factors (0.01→0.1 at W ×10) while bearing-range factors "
      "stay at (1, 1) — a relative reweighting toward landmarks that the "
      "W-dial family sweep below traces point by point. Scored against "
      "ALL 22 published numbers (combined 95% CI = published 10-run CI ⊕ "
      "repo Monte-Carlo CI):\n")
    w("| Hypothesis | all-22 scorecard |")
    w("|---|---|")
    for wname, _, _ in family:
        label = {"1 (C)": "C: V_11 ×10, W ×1",
                 "10 (D)": "D: V_11 ×10, W ×10"}.get(
            wname, f"V_11 ×10, W ×{wname}")
        b = "**" if wname == adopted_name else ""
        ad = " (adopted)" if wname == adopted_name else ""
        w(f"| {b}{label}{ad}{b} | {b}{summarize(scores[wname])}{b} |")
    w("")

    w("## Calibration\n")
    w("The scalar noise scale is calibrated per regime against the "
      "published naive baseline (dead reckoning is W-blind, so the "
      "calibration holds across the whole W family):\n")
    w("| Regime | dial | target naive (m) | measured naive (m) |")
    w("|---|---|---|---|")
    for reg in ("high", "low"):
        c = cal[reg]
        last = c["history"][-1]
        dial = ("V_11 ×" + f"{c['scale']:g}") if reg == "high" \
            else "none (params.yaml)"
        w(f"| {reg} | {dial} | {c['target_naive_m']:.3f} | "
          f"{last['mean']:.3f} ± {last['ci95']:.3f} |")
    w("")

    w("## Solo filters (context columns)\n")
    solo_members = [(n, cf, dt) for n, cf, dt in family
                    if "solo_naive_high" in cf]
    w("| Config | published (m) | " + " | ".join(
        f"W ×{n} (m), n={dt['worlds']}" for n, _, dt in solo_members) + " |")
    w("|---|---|" + "---|" * len(solo_members))
    pub_span = {"solo_naive_high": "2.209–2.277",
                "solo_ekf_slam_high": "0.930–1.397",
                "solo_naive_low": "0.244–0.270",
                "solo_ekf_slam_low": "0.188–0.267"}
    low_w_evidence = []
    for name, span in pub_span.items():
        cst = c_cfgs.get(name)
        if cst is None:
            continue
        k = [x for x in cst if x not in ("wall_s", "timing")][0]
        cells = []
        for wname, cfgs_f, _ in solo_members:
            st = cfgs_f.get(name)
            if st is None:
                cells.append("—")
                continue
            # Interior members (independent --w-scale) also ran the LOW
            # solos with the W dial applied — a counterfactual that is the
            # exclusion evidence for a hidden low-noise W dial, NOT the
            # member's low-noise prediction (low = all dials ×1, shared
            # with C). Show the shared value; collect the counterfactual.
            if "_low" in name and wname not in ("1 (C)", "10 (D)"):
                if name == "solo_ekf_slam_low" and \
                        abs(st[k]["mean"] - cst[k]["mean"]) > 1e-12:
                    low_w_evidence.append(
                        f"W ×{wname}: {st[k]['mean']:.3f} ± "
                        f"{st[k]['ci95']:.3f}")
                cells.append(f"{cst[k]['mean']:.3f} ± "
                             f"{cst[k]['ci95']:.3f} †")
                continue
            cells.append(f"{st[k]['mean']:.3f} ± {st[k]['ci95']:.3f}")
        w(f"| {name} | {span} | " + " | ".join(cells) + " |")
    w("")
    w("The low-noise solos are one shared set across the family (†): the "
      "calibrated low scale is ~1 and the W dial is ×1 at low noise for "
      "every member, so all dials sit at their params.yaml values."
      + (" A hidden low-noise W dial is excluded by measurement — "
         "applying it drives the compat EKF solo out of the published "
         "band (" + "; ".join(low_w_evidence) + " vs published "
         "0.188–0.267), on top of the W ×10 exclusion (0.94 m)."
         if low_w_evidence else "") + "\n")

    headline_cfgs = adopted_cfgs
    a_shared = any(st.get("shared_with_c") for st in adopted_cfgs.values())
    a_high = next((adopted_cfgs[r] for r in ROWS
                   if "_high_" in r and r in adopted_cfgs
                   and "secondary" in adopted_cfgs[r]), None)
    n_one = (a_high or {}).get("secondary", {}).get(
        "n", adopted_data.get("worlds"))
    n_it = next((adopted_cfgs[r]["secondary"]["n"] for r in ROWS
                 if r.endswith("_iter") and "_high_" in r
                 and r in adopted_cfgs
                 and "secondary" in adopted_cfgs[r]), n_one)
    w(f"## The 8 published pose-graph configs (adopted profile: W ×{a_w})\n")
    w(f"✓ = the repo mean lies within the combined 95% CI (published "
      f"10-run CI ⊕ repo Monte-Carlo CI; n={n_one} worlds "
      f"one-time / {n_it} iterative at high noise; low-noise rows "
      f"n={c_data['worlds']}/{c_data.get('worlds_iter', 128)}). "
      + ("† = low-noise row shared across the family by construction "
         "(all dials ×1 at the calibrated low scale).\n" if a_shared
         else "\n"))
    w("| Config | ref secondary | repo secondary | ref PGS-init | repo "
      "PGS-init | ref PGS-result | repo PGS-result |")
    w("|---|---|---|---|---|---|---|")
    n_done = 0
    for name in ROWS:
        st = headline_cfgs.get(name)
        if st is None or "secondary" not in st:
            w(f"| {name} | (pending) | | | | | |")
            continue
        n_done += 1
        ref = st["reference"]
        tag = "†" if st.get("shared_with_c") else ""
        w(f"| {name}{tag} | "
          f"{fmt_pair(ref['secondary'], st['secondary'], pub_lookup(stats, name, 'secondary'))} | "
          f"{fmt_pair(ref['pgs_initial'], st['pgs_initial'], pub_lookup(stats, name, 'pgs_initial'))} | "
          f"{fmt_pair(ref['pgs_result'], st['pgs_result'], pub_lookup(stats, name, 'pgs_result'))} |")
    w("")

    # Scorecard columns: C and D (the endpoints) plus the adopted interior
    # member when it is neither.
    score_cols = [("1 (C)", "C"), ("10 (D)", "D")]
    if adopted_name not in ("1 (C)", "10 (D)"):
        score_cols.append((adopted_name, f"W ×{a_w}"))
    score_cols = [(n, lbl) for n, lbl in score_cols
                  if any(fn == n for fn, _, _ in family)]
    by_key = {n: {(r["name"], r["col"]): r for r in scores[n]}
              for n, _, _ in family}
    cfgs_by_name = {n: cf for n, cf, _ in family}

    w("## Scorecard: every published number, "
      + " vs ".join(lbl for _, lbl in score_cols) + "\n")
    w("Published ± is the 95% CI of the reference's own ~10 runs "
      "(docs/reference_runs_stats.json); repo ± is the Monte-Carlo CI. "
      "✓ = inside the combined CI; the last column is the adopted "
      f"profile's (W ×{a_w}) relative error.\n")
    w("| Config / column | published | "
      + " | ".join(lbl for _, lbl in score_cols) + " | rel |")
    w("|---|---|" + "---|" * (len(score_cols) + 1))

    def cell(r):
        if r is None:
            return "—"
        return (f"{r['mean']:.3f} ± {r['ci']:.3f}"
                + (" ✓" if r["inside"] else ""))

    n_excl = 0
    for name in ROWS:
        for col in COLS:
            pub = pub_lookup(stats, name, col)
            if pub is None:
                continue
            if name.endswith("_iter") and col == "pgs_initial":
                n_excl += 1
                cells = []
                for n, _ in score_cols:
                    st = cfgs_by_name[n].get(name)
                    cells.append(
                        f"{st[col]['mean']:.3f} ± {st[col]['ci95']:.3f}"
                        if st and col in st else "—")
                w(f"| {name}/{col} ‡ | {pub['mean']:.3f} ± "
                  f"{pub['ci95']:.3f} | " + " | ".join(cells) + " | n/a |")
                continue
            rows_ = [by_key[n].get((name, col)) for n, _ in score_cols]
            if not any(rows_):
                continue
            ar = by_key[adopted_name].get((name, col))
            w(f"| {name}/{col} | "
              f"{pub['mean']:.3f} ± {pub['ci95']:.3f} | "
              + " | ".join(cell(r) for r in rows_) + " | "
              + (f"{ar['rel']:+.0%} |" if ar else "— |"))
    w("")
    if n_excl:
        w("‡ excluded from the totals: the reference's iter-mode published "
          "\"initial\" (`i_pgs_old.csv`) is the fed-back previous solve "
          "(pose_graph.cpp:262-267), a different statistic from this "
          "repo's seeded-node-values initial.\n")
    w("Totals — " + " ".join(
        f"{lbl}: {summarize(scores[n])}." for n, lbl in score_cols) + "\n")

    # ---- W-dial family sweep (r5): C and D are the endpoints of a
    # one-parameter family; the intermediate scales show whether ANY single
    # profile can satisfy all the high-noise columns at once.
    if len(family) > 2:
        w("### The W-dial family: is there a single profile at all?\n")
        w("C (W ×1) and D (W ×10) are endpoints of a one-parameter family; "
          "`--w-scale` traces the interior (W ×3 and W ×5, 128 worlds "
          "one-time / 64 iterative, on-chip). Every high-noise published "
          "statistic against the family:\n")
        w("| Statistic | published | " +
          " | ".join(f"W ×{n}" for n, _, _ in family) + " |")
        w("|---|---|" + "---|" * len(family))
        high_rows = [r for r in ROWS if "_high_" in r]
        for name in high_rows:
            for col in COLS:
                pub = pub_lookup(stats, name, col)
                if pub is None or col == "pgs_initial":
                    continue
                cells = []
                for _, cfgs_f, _ in family:
                    st = cfgs_f.get(name)
                    if st is None or col not in st:
                        cells.append("—")
                        continue
                    m, ci = st[col]["mean"], st[col]["ci95"]
                    comb = math.sqrt(pub["ci95"] ** 2 + ci ** 2)
                    mark = " ✓" if abs(m - pub["mean"]) <= comb else ""
                    cells.append(f"{m:.3f}{mark}")
                w(f"| {name}/{col} | {pub['mean']:.3f} ± "
                  f"{pub['ci95']:.3f} | " + " | ".join(cells) + " |")
        w("")
        w("Scorecards per family member — high-noise-only (the 10 numbers "
          "above + the 2 one-time pgs_initial columns) and all 20 "
          "published numbers (low-noise rows are W ×1 for every member — "
          "a hidden low-noise W dial is excluded by measurement, so the "
          "low rows are one shared set). **Reachability** asks whether "
          "the naive-seeded pgs_result misses can be explained by the "
          "solver-convergence DOF: early stopping can only leave the "
          "published value ABOVE the converged optimum, so a converged "
          "mean BELOW published is explainable, one ABOVE it is a "
          "structural miss no stopping rule can produce.\n")
        # Converged floors from the solver-budget sweeps
        # (naive_high_one_time only — that is the config every sweep ran).
        # The default-budget family values are not converged optima for
        # every member, so reachability is judged at each member's measured
        # floor when a sweep exists.
        floor_files = {"1 (C)": ("pgs_convergence_cx.json",
                                 "pgs_budget_probe.json"),
                       "3": ("pgs_convergence_w3x.json",),
                       "5": ("pgs_convergence_w5x.json",),
                       "10 (D)": ("pgs_convergence_d.json",)}
        floors = {}
        for wname, fnames in floor_files.items():
            for fname in fnames:
                cj = load_json(os.path.join(base_dir, fname))
                if not cj or not cj.get("budgets"):
                    continue
                k, st = min(cj["budgets"].items(),
                            key=lambda kv: kv[1]["pgs_result"]["mean"])
                floors[wname] = (st["pgs_result"]["mean"],
                                 st["pgs_result"]["ci95"], k, fname,
                                 st["pgs_result"].get("n", cj.get("worlds")))
                break
        w("| Profile | high-noise | all 20 | naive pgs_result misses "
          "reachable by early stopping? |")
        w("|---|---|---|---|")
        for wname, cfgs_f, _ in family:
            sc = scores[wname]
            hs = [r for r in sc if "_high_" in r["name"]]
            # reachability of the naive-seeded pgs_result columns
            reach, labels = True, []
            for nm in ("naive_high_one_time", "naive_high_iter"):
                r = next((x for x in sc if x["name"] == nm
                          and x["col"] == "pgs_result"), None)
                if r is None or r["inside"]:
                    continue
                fl = floors.get(wname) if nm == "naive_high_one_time" else None
                if fl is not None:
                    fm, fci, fk, _, fn = fl
                    comb = math.sqrt(r["pub_ci"] ** 2 + fci ** 2)
                    ok = fm <= r["pub_mean"] + comb
                    reach &= ok
                    labels.append(
                        f"{'floor' if ok else 'UNREACHABLE: floor'} "
                        f"{fm:.2f} ({fk}, n={fn}) vs {r['pub_mean']:.2f}")
                else:
                    comb = math.sqrt(r["pub_ci"] ** 2 + r["ci"] ** 2)
                    ok = r["mean"] <= r["pub_mean"] + comb
                    reach &= ok
                    labels.append(
                        f"{'converged below' if ok else 'UNREACHABLE: converged'}"
                        f" {r['mean']:.2f} vs {r['pub_mean']:.2f}")
            verdict = "no misses" if not labels else (
                ("yes — " if reach else "no — ") + "; ".join(labels))
            w(f"| W ×{wname} | {summarize(hs)} | {summarize(sc)} | "
              f"{verdict} |")
        w("")
        if floors:
            w("Floors are each member's best measured pgs_result over its "
              "solver-budget sweep (naive_high_one_time; "
              + ", ".join(f"W ×{n}: `{f}`" for n, (_, _, _, f, _)
                          in floors.items()) + ").\n")

    conv_file = {"1 (C)": "pgs_convergence_cx.json",
                 "3": "pgs_convergence_w3x.json",
                 "5": "pgs_convergence_w5x.json",
                 "10 (D)": "pgs_convergence_d.json"}[adopted_name]
    conv = load_json(os.path.join(base_dir, conv_file))
    if conv is None and adopted_name != "10 (D)":
        conv_file = "pgs_convergence_d.json"
        conv = load_json(os.path.join(base_dir, conv_file))
    if conv:
        conv_w = conv.get("w_scale") or (10.0 if conv.get("scale_w") else 1.0)
        w("## The naive-secondary residual: a solver-convergence DOF\n")
        w("The adopted profile's remaining high-noise misses concentrate "
          "where the pose graph is initialized from dead reckoning "
          "(naive_high_*/pgs_result). The reference solves with GTSAM LM "
          "from that initial estimate (pose_graph.cpp:283-284) and stops "
          "on its default relative-decrease tolerance; this repo's bulk "
          "solver runs a fixed Schur-PCG GN budget to convergence. "
          "Sweeping the budget traces the optimizer's convergence path "
          f"(naive_high_one_time at W ×{conv_w:g}, n={conv['worlds']} "
          f"worlds on-chip, `docs/{conv_file}`):\n")
        w("| GN budget | PGS result (m) |")
        w("|---|---|")
        path_vals = []
        for k, v in conv["budgets"].items():
            path_vals.append((k, v["pgs_result"]["mean"],
                              v["pgs_result"]["ci95"]))
            w(f"| {k.split('x')[0]} | {v['pgs_result']['mean']:.3f} ± "
              f"{v['pgs_result']['ci95']:.3f} |")
        w("")
        means = [p[1] for p in path_vals]
        pub = pub_lookup(stats, "naive_high_one_time", "pgs_result")
        if pub and means and min(means) <= pub["mean"] <= max(
                max(means), conv.get("init_mean", 2.27)):
            w(f"The published {pub['mean']:.3f} ± {pub['ci95']:.3f} lies ON "
              "this path — between partial and full convergence — so the "
              "published naive-config results are consistent with the "
              "adopted profile plus an optimizer that stops earlier from a "
              "poor initial estimate than this repo's fixed-budget solver "
              "does. The repo's converged optimum is *better* than the "
              "published numbers, not differently wrong.\n")
        elif pub and means and min(means) > pub["mean"]:
            w(f"The published {pub['mean']:.3f} ± {pub['ci95']:.3f} lies "
              f"BELOW the sweep's best point ({min(means):.3f}); see the "
              "family reachability table for whether the gap is inside the "
              "combined CI at the floor.\n")

    w("## What remains unexplained\n")
    misses = [r for r in adopted_score if not r["inside"]]
    if misses:
        w(f"Under the adopted profile (W ×{a_w}), the numbers outside the "
          "combined 95% CI are:\n")
        for r in sorted(misses, key=lambda r: -abs(r["rel"])):
            w(f"- `{r['name']}/{r['col']}`: published {r['pub_mean']:.3f} ± "
              f"{r['pub_ci']:.3f} vs repo {r['mean']:.3f} ± {r['ci']:.3f} "
              f"({r['rel']:+.0%})")
        w("")
    # Low-noise convergence floors (phase-8 sweeps): do the published
    # low-noise pgs_result values lie on the solver's convergence path
    # the way the high-noise one does?
    low_sweeps = [("naive_low_one_time", "pgs_convergence_low.json"),
                  ("ekf_slam_low_one_time", "pgs_convergence_low_ekf.json")]
    low_rows = []
    for nm, fname in low_sweeps:
        cj = load_json(os.path.join(base_dir, fname))
        pub = pub_lookup(stats, nm, "pgs_result")
        if cj and cj.get("budgets") and pub:
            low_rows.append((nm, fname, cj, pub))
    if low_rows:
        w("### The low-noise misses against the same convergence DOF\n")
        w("The low-noise pgs_result misses carry the high-noise signature "
          "— repo above published at the default 50×40 budget — so the "
          "same sweep was run at the calibrated low profile (64 worlds "
          "on-chip, one_time, W ×1; the low rows are family-shared):\n")
        hdr_keys = list(low_rows[0][2]["budgets"].keys())
        w("| config | " + " | ".join(f"GN {k.split('x')[0]}"
                                     for k in hdr_keys)
          + " | published | verdict |")
        w("|---|" + "---|" * (len(hdr_keys) + 2))
        n_explained = 0
        for nm, fname, cj, pub in low_rows:
            cells, floor = [], None
            for k in hdr_keys:
                st = cj["budgets"].get(k)
                if st is None:
                    cells.append("—")
                    continue
                m, ci = st["pgs_result"]["mean"], st["pgs_result"]["ci95"]
                cells.append(f"{m:.3f} ± {ci:.3f}")
                if floor is None or m < floor[0]:
                    floor = (m, ci)
            comb = math.sqrt(pub["ci95"] ** 2 + floor[1] ** 2)
            ok = floor[0] <= pub["mean"] + comb
            n_explained += ok
            verdict = ("published ON the path — explainable by early "
                       "stopping" if ok else
                       f"floor stays {floor[0] / pub['mean'] - 1:+.0%} "
                       "above published — NOT a convergence artifact")
            w(f"| {nm} (`{fname}`) | " + " | ".join(cells)
              + f" | {pub['mean']:.3f} ± {pub['ci95']:.3f} | {verdict} |")
        w("")
        if n_explained == len(low_rows):
            w("Both measured low-noise floors pass through the published "
              "values: every pgs_result miss under the adopted profile — "
              "high and low noise — is accounted for by the measured "
              "solver-convergence DOF, and the iter-mode rows share the "
              "same solver and graph shape. The only residuals left "
              "without a measured mechanism are low-noise secondary-filter "
              "rows within ±21%, bounded by structural fact 3 below.\n")
        elif n_explained == 0:
            w("Neither low floor reaches the published value: the "
              "low-noise misses are NOT a convergence artifact — the "
              "tight-published-CI attribution (structural fact 3) is the "
              "operative explanation there.\n")
        else:
            w("The floors split: one low miss is convergence-explainable, "
              "the other is not — structural fact 3 remains the operative "
              "explanation for the remainder.\n")

    # adopted profile's EKF-secondary value vs the two published run dirs
    a_sec = next((r for r in adopted_score
                  if r["name"] == "ekf_slam_high_one_time"
                  and r["col"] == "secondary"), None)
    sec_txt = (f"(the adopted profile's single value, "
               f"{a_sec['mean']:.2f}, must answer for both)"
               if a_sec else "")
    w("Three structural facts bound what any single-profile reconstruction "
      "can achieve:\n")
    w("1. **The published data is internally inconsistent at its own CI "
      "level in places.** The EKF secondary column is the same filter at "
      "the same nominal config in both high-noise run dirs, yet publishes "
      "0.930 ± 0.298 (one_time) and 1.397 ± 0.705 (iter) — a 0.47 m "
      "spread between means of identical configurations. Any single "
      f"profile produces ONE value for that column {sec_txt}.")
    w("2. **The naive-config pose-graph results carry a solver-convergence "
      "degree of freedom** the published CSVs don't record (GTSAM LM "
      "stopping criteria vs this repo's fixed budget) — see the "
      "convergence-path section: the repo's solver converges past the "
      "published point to a better optimum.")
    w("3. **The low-noise rows are reproduced to 0.02–0.05 m absolute** "
      "(all within 10–25% relative) but several sit outside the published "
      "CIs, which are extremely tight there (±0.012–0.055 m on ~10 runs); "
      "at that resolution unrecorded details (exact map seeds, TSP tour "
      "lengths, matplotlib-era metric sampling) dominate.")
    w("")

    w("## Appendix: the exclusion chain that led to the W-dial family\n")
    w("Before the W dial was identified, the high-noise pgs_result residual under C "
      "(repo 1.83 vs published 0.93 for the naive secondary — above even "
      "the published 10-run max of 1.79) was probed mechanism by "
      "mechanism (`scripts/pgs_budget_probe.py`, 8 worlds, T=1000, "
      "C profile):\n")
    w("| Probe | result | verdict |")
    w("|---|---|---|")
    bp = load_json(os.path.join(base_dir, "pgs_budget_probe.json"))
    if bp:
        span = " → ".join(
            f"{k}: {v['pgs_result']['mean']:.2f}"
            for k, v in bp["budgets"].items())
        w(f"| Solver budget (GN×CG sweep) | {span} | converged by 150×40 — "
          "not an iteration-budget artifact |")
    cx = load_json(os.path.join(base_dir, "pgs_convergence_cx.json"))
    if cx and len(cx.get("budgets", {})) > 1:
        span = " → ".join(
            f"{k}: {v['pgs_result']['mean']:.2f}"
            for k, v in cx["budgets"].items())
        w(f"| Solver budget, re-run at the uniform protocol "
          f"(n={cx['worlds']}, chip) | {span} | C's floor stays far above "
          "the published 0.93 — exclusion confirmed at matrix scale |")
    cp = load_json(os.path.join(base_dir, "pgs_chordal_probe.json"))
    if cp:
        k, v = next(iter(cp["budgets"].items()))
        w(f"| Chordal cold-start (vs secondary seeding) | {k}: "
          f"{v['pgs_result']['mean']:.2f} | identical optimum — not an "
          "initialization basin |")
    dp = load_json(os.path.join(base_dir, "pgs_dense_probe.json"))
    if dp:
        k, v = next(iter(dp["budgets"].items()))
        w(f"| Graduated dense LM (GTSAM-style, n={dp['worlds']}) | init "
          f"{v['pgs_initial']['mean']:.2f} → {v['pgs_result']['mean']:.2f} | "
          "same relative improvement — not GN-vs-LM |")
    w("")
    w("The graph noise wiring was audited against the reference: "
      "`readCommonParams` (filter.h:110-117) overwrites V with the sensing "
      "covariances and leaves W at identity, so the reference graph's "
      "between-factor sigmas are `(W_00, W_00, W_11)` and its "
      "bearing-range sigmas are `(1, 1)` — exactly what the repo's compat "
      "path builds (`_noise_sigmas`, models/posegraph.py). Under C that "
      "makes the between-factors sigma (0.01, 0.01, 0.01); under D they "
      "loosen to (0.1, 0.1, 0.1), which is the reweighting that closes "
      "the pgs_result gap.\n")
    w("### Remaining-DOF sweep (landmark density, sensing range)\n")
    w("| Variant | worlds | PGS result (naive sec., high, C profile) | "
      "source |")
    w("|---|---|---|---|")
    w("| nl=20 (committed), 50×40 | 256, chip | 1.83 ± 0.11 | headline "
      "C table |")
    w("| nl=20, range_max 3→6 m, 150×40 | 8, CPU | 1.50 | "
      "docs/pgs_range6.json |")
    w("| nl=40, 150×40 | 8, CPU | 1.72 | docs/pgs_lmdensity_40.json |")
    w("| nl=60, 150×40 | 8, CPU | 0.91 | docs/pgs_lmdensity_60.json |")
    lm = load_json(os.path.join(base_dir, "parity_lm60.json"))
    if lm:
        w(f"| nl=60, 50×40 | {lm['worlds']}, chip | "
          f"{lm['pgs_result']['mean']:.2f} ± {lm['pgs_result']['ci95']:.2f} "
          "| docs/parity_lm60.json |")
    for path, label in (
            ("parity_lm60_150x40.json", "nl=60, 150×40"),
            ("parity_lm20_150x40.json", "nl=20, 150×40"),
            ("pgs_lmdensity_60_w32.json", "nl=60, 150×40 (CPU)")):
        sweep = load_json(os.path.join(base_dir, path))
        if sweep is None:
            continue
        if "budgets" in sweep:
            st = next(iter(sweep["budgets"].values()))["pgs_result"]
        else:
            st = sweep["pgs_result"]
        w(f"| {label} | {sweep['worlds']}, "
          f"{'CPU' if 'budgets' in sweep else 'chip'} | "
          f"{st['mean']:.2f} ± {st['ci95']:.2f} | docs/{path} |")
    w("| published | ~10 runs | 0.93 | base_pkg/data |")
    w("")
    w("An 8-world nl=60 probe initially suggested landmark density was the "
      "lever (0.91, matching the published 0.93); a 64-world on-chip rerun "
      "did NOT reproduce it (1.79 ± 0.27) — the small-n result confounded "
      "density with the solver budget and its particular 8 maps. Density "
      "and sensing range are excluded at matched budget and proper world "
      "count; the dial that actually closes the gap is the W dial's "
      "between-factor reweighting above (best joint fit at the adopted "
      f"W ×{a_w}).\n")
    w("Commands: C rows: `scripts/reference_parity.py --profile ang`; D "
      "rows: `--profile ang --scale-w`; interior W ×k rows: `--profile ang "
      "--w-scale k` (resume-safe).\n")

    with open(args.out, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {args.out} ({n_done}/8 PGS rows)")


if __name__ == "__main__":
    main()
