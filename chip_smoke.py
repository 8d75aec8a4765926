"""Start-up check of the Monte-Carlo EKF-SLAM path on one NVIDIA GPU.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: the world-parallel path only

Phases (one process; any failure exits non-zero):

1. device: JAX must report a GPU; the card's name and power limit are read
   from ``nvidia-smi`` before JAX touches the card.
2. cli: ``cli.main(["monte_carlo", ...])``, the XLA vmap(scan) path, at the
   headline size (4096 worlds, T=1000, 20 landmarks: D=43).
3. runner: ``run_monte_carlo(..., impl="fused")`` for ekf_slam and iekf_slam
   at the same size (the CUDA kernel, ops/ekf_rollout.cu).
4. kernel: the kernel against its plain-JAX reference
   (``reference_ekf_rollout``) on identical inputs and noise at full width,
   with the tolerances printed; then both timed (warm-up, median of 5 runs,
   each ended by block_until_ready; noise generation inside the timed
   window) with their ``memory_analysis()``.
5. streams: ``run_monte_carlo_pg_streams`` with an EKF secondary, which
   runs the kernel's ``emit_traj`` form (64 worlds, T=1000).
6. ukf: the XLA UKF-SLAM path (sigma_sqrt="chol") timed at 4096 worlds.

``--four-cards`` runs only the world-parallel path: the kernel under
``fused_ekf_rollout_sharded`` over a 4-device ``worlds`` mesh at 4 x 4096
worlds against one device on the same worlds and noise, and the XLA step
sharded with parallel/mesh.py and its metric all-reduce against one device.

The last line of stdout is one JSON object: ``{"ok": true, "device":
{"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import subprocess
import sys
import time

WORLDS = 4096
STEPS = 1000
# per-world average position error (m) of a healthy EKF-SLAM / RI-EKF run
# at the default noise (tests/test_iekf.py long-horizon bound)
ERR_RANGE = (0.0, 0.5)
# worlds whose error ever left DIVERGENCE_RADIUS may be at most this share
MAX_DIVERGED_SHARE = 0.01
# kernel vs plain reference, same inputs and noise, T=1000: fp32 reordering
# in a 1000-tick filter, so per-world metrics and states agree closely but
# not bit for bit
TOL = {
    "avg_err_abs": 5e-3,     # m, per world
    "mean_err_rel": 1e-3,    # relative, batch mean
    "x_abs": 2e-2,           # m / rad, final filter state
    "true_pose_abs": 1e-2,   # m / rad, final true pose
    "seen_share": 0.999,     # share of equal seen flags
}
REPS = 5


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    """The card's name and power limit, read without JAX."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


@contextlib.contextmanager
def phase(name: str):
    log(f"== {name}")
    t0 = time.perf_counter()
    yield
    log(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)")


def timed(fn, *args, reps: int = REPS):
    """Warm-up call, then `reps` calls each ended by block_until_ready;
    returns (per-call seconds, last output)."""
    import jax

    out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return times, out


def median(xs):
    import numpy as np

    return float(np.median(xs))


def check_errors(name, err, diverged):
    """Finite, plausible per-world errors and few diverged worlds."""
    import numpy as np

    err = np.asarray(err)
    diverged = np.asarray(diverged)
    ok = ~diverged
    mean = float(np.mean(err[ok]))
    log(f"{name}: mean avg-pos-err {mean!r} m over {int(ok.sum())} worlds; "
        f"diverged {int(diverged.sum())} of {err.size}")
    assert err.shape == (WORLDS,), err.shape
    assert np.isfinite(err[ok]).all(), f"{name}: non-finite errors"
    assert ERR_RANGE[0] < mean < ERR_RANGE[1], f"{name}: mean error {mean}"
    assert diverged.sum() <= MAX_DIVERGED_SHARE * err.size, name
    return mean


def make_inputs(cfg, batch, seed=0):
    """Random 20-landmark maps and TSP command streams, one per world."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from live_ekf_slam_tpu.sim import maps as sim_maps
    from live_ekf_slam_tpu.sim.trajectory import generate_trajectory

    lms = jnp.asarray(sim_maps.random_landmarks_batched(
        cfg, np.random.default_rng(seed), batch))
    cmds = jax.jit(jax.vmap(
        lambda l, k: generate_trajectory(cfg, l, l.shape[0], k)
    ))(lms, jax.random.split(jax.random.PRNGKey(seed + 1), batch))
    return lms, cmds


def compile_rollout(rollout, cfg, kind, lms, cmds):
    """jit(noise generation + rollout), compiled for these inputs."""
    import jax

    from live_ekf_slam_tpu.ops.fused_rollout import rollout_noise

    b, n_lm, _ = lms.shape
    t_total = cmds.shape[1]

    def run(lms, cmds, key):
        noise = rollout_noise(key, b, t_total, n_lm)
        return rollout(cfg, lms, cmds, noise, filter_kind=kind)

    key = jax.random.PRNGKey(2)
    lowered = jax.jit(run).lower(lms, cmds, key)
    t0 = time.perf_counter()
    compiled = lowered.compile()
    return compiled, lowered.as_text(), time.perf_counter() - t0


def compare(kind, a, b, t_total):
    """Kernel outputs `a` against reference outputs `b` (numpy dicts)."""
    import numpy as np

    ea, eb = a["err_sum"] / t_total, b["err_sum"] / t_total
    fin = (np.isfinite(a["err_max"]) & np.isfinite(b["err_max"])
           & (a["err_max"] < 50.0) & (b["err_max"] < 50.0))
    d_err = float(np.max(np.abs(ea - eb)[fin]))
    rel = float(abs(ea[fin].mean() - eb[fin].mean()) / eb[fin].mean())
    d_x = float(np.max(np.abs(a["x"] - b["x"])[fin]))
    d_pose = float(np.max(np.abs(a["true_pose"] - b["true_pose"])))
    seen = float(np.mean(a["seen"] == b["seen"]))
    div_a, div_b = (int(np.sum(~(np.isfinite(o["err_max"])
                                 & (o["err_max"] < 50.0)))) for o in (a, b))
    log(f"{kind} kernel vs plain: mean err {float(ea[fin].mean())!r} vs "
        f"{float(eb[fin].mean())!r} (rel {rel!r}, tol {TOL['mean_err_rel']})")
    log(f"{kind} max |d avg-pos-err| {d_err!r} (tol {TOL['avg_err_abs']}); "
        f"max |d x| {d_x!r} (tol {TOL['x_abs']}); max |d true pose| "
        f"{d_pose!r} (tol {TOL['true_pose_abs']}); seen equal {seen!r} "
        f"(tol {TOL['seen_share']}); diverged {div_a} vs {div_b}")
    assert d_err <= TOL["avg_err_abs"], kind
    assert rel <= TOL["mean_err_rel"], kind
    assert d_x <= TOL["x_abs"], kind
    assert d_pose <= TOL["true_pose_abs"], kind
    assert seen >= TOL["seen_share"], kind
    assert div_a == div_b, kind


def xla_rollout(cfg, t_total):
    """The models/ path as vmap(scan(step)) over worlds: (lms, cmds, keys)
    -> per-world average position error."""
    import jax
    import jax.numpy as jnp

    from live_ekf_slam_tpu.eval.runner import init_carry, make_step

    step = make_step(cfg, collect="sums")

    def rollout(lms, cmds, keys):
        tick_keys = jax.vmap(lambda k: jax.random.split(k, t_total))(keys)
        carry = jax.vmap(lambda l: init_carry(cfg, l))(lms)
        final, _ = jax.lax.scan(
            lambda c, inp: jax.vmap(step)(c, inp), carry,
            (jnp.swapaxes(cmds, 0, 1), jnp.swapaxes(tick_keys, 0, 1)),
        )
        return final.err_sum_primary / t_total

    return rollout


# --------------------------------------------------------------------------
# one card


def phase_cli():
    from live_ekf_slam_tpu import cli

    buf = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, s):
            buf.write(s)
            return sys.__stdout__.write(s)

    with contextlib.redirect_stdout(Tee()):
        rc = cli.main(["monte_carlo", "--filter", "ekf_slam", "--batch",
                       str(WORLDS), "--steps", str(STEPS)])
    assert rc == 0, rc
    text = buf.getvalue()
    m = re.search(r"^ekf_slam: mean (\S+) std (\S+)$", text, re.M)
    d = re.search(r"^diverged_ekf_slam: (\d+) of (\d+) worlds$", text, re.M)
    assert m and d, text
    mean, n_div, n = float(m.group(1)), int(d.group(1)), int(d.group(2))
    assert n == WORLDS, n
    assert ERR_RANGE[0] < mean < ERR_RANGE[1], mean
    assert n_div <= MAX_DIVERGED_SHARE * n, n_div
    return mean


def phase_runner(xla_mean):
    import jax

    from live_ekf_slam_tpu.config import Config
    from live_ekf_slam_tpu.eval.runner import run_monte_carlo

    for filt in ("ekf_slam", "iekf_slam"):
        cfg = Config(num_iterations=STEPS).replace(filter=filt)
        t0 = time.perf_counter()
        res, _, _ = run_monte_carlo(
            cfg, jax.random.PRNGKey(0), WORLDS, seed=0, impl="fused")
        log(f"{filt} impl=fused: {time.perf_counter() - t0:.1f} s "
            "(first call: library build and compile included)")
        mean = check_errors(f"{filt} impl=fused", res["err_" + filt],
                            res["diverged_" + filt])
        if filt == "ekf_slam":
            # the XLA path draws its noise differently: a statistical match
            rel = abs(mean - xla_mean) / xla_mean
            log(f"ekf_slam fused vs cli (xla) mean: rel diff {rel!r} (tol 0.1)")
            assert rel < 0.1, (mean, xla_mean)


def phase_kernel(card):
    import jax
    import numpy as np

    from live_ekf_slam_tpu.config import Config
    from live_ekf_slam_tpu.ops import fused_rollout as fr

    cfg = Config(num_iterations=STEPS)
    lms, cmds = make_inputs(cfg, WORLDS)
    key = jax.random.PRNGKey(2)
    log(f"matmul precision: jax_default_matmul_precision="
        f"{jax.config.jax_default_matmul_precision!r}; the rollouts are "
        "elementwise float32 (no dot products)")
    for kind in ("ekf", "iekf"):
        outs, times = {}, {}
        for name, fn in (("kernel", fr.fused_ekf_rollout),
                         ("plain", fr.reference_ekf_rollout)):
            compiled, text, compile_s = compile_rollout(fn, cfg, kind, lms,
                                                        cmds)
            on_card = "les_ekf_rollout" in text
            log(f"{kind} {name}: compile {compile_s:.1f} s; CUDA kernel "
                f"custom call in the program: {on_card}")
            assert on_card == (name == "kernel"), (kind, name)
            log(f"{kind} {name} memory_analysis: {compiled.memory_analysis()}")
            ts, out = timed(compiled, lms, cmds, key)
            times[name] = ts
            outs[name] = jax.tree.map(np.asarray, out)
            log(f"{kind} {name} times s: {ts!r}")
        compare(kind, outs["kernel"], outs["plain"], STEPS)
        tk, tp = median(times["kernel"]), median(times["plain"])
        log(f"{kind} at {WORLDS} worlds x T={STEPS}: kernel {tk!r} s, plain "
            f"{tp!r} s (median of {REPS}); plain/kernel {tp / tk!r}; "
            f"card {card}")


def phase_streams():
    import dataclasses

    import jax
    import numpy as np

    from live_ekf_slam_tpu.config import Config
    from live_ekf_slam_tpu.eval.runner import run_monte_carlo_pg_streams

    cfg = Config(num_iterations=STEPS).replace(filter="pose_graph")
    cfg = cfg.replace(pose_graph=dataclasses.replace(
        cfg.pose_graph, filter_to_compare="ekf_slam",
        solve_graph_every_iteration=False))
    res, _, _ = run_monte_carlo_pg_streams(
        cfg, jax.random.PRNGKey(3), batch=64, seed=3, impl="fused")
    for k, v in sorted(res.items()):
        v = np.asarray(v)
        log(f"streams {k}: shape {v.shape} "
            + (f"sum {int(v.sum())}" if v.dtype == bool
               else f"mean {float(np.mean(v))!r}"))
        assert v.shape == (64,), (k, v.shape)
        if v.dtype != bool:
            assert np.isfinite(v).all(), k
    assert ERR_RANGE[0] < float(np.mean(res["err_ekf_slam"])) < ERR_RANGE[1]


def phase_ukf(card):
    import jax
    import numpy as np

    from live_ekf_slam_tpu.config import Config

    t_total = 100
    cfg = Config(num_iterations=t_total).replace(filter="ukf_slam")
    cfg = cfg.replace(ukf=cfg.ukf.__class__(sigma_sqrt="chol"))
    lms, cmds = make_inputs(cfg, WORLDS)
    keys = jax.random.split(jax.random.PRNGKey(4), WORLDS)
    times, err = timed(jax.jit(xla_rollout(cfg, t_total)), lms, cmds, keys)
    err = np.asarray(err)
    log(f"ukf_slam xla (chol) at {WORLDS} worlds x T={t_total}: median "
        f"{median(times)!r} s, {t_total / median(times)!r} steps/s/world; "
        f"times {times!r}; mean err {float(err.mean())!r}; card {card}")
    assert np.isfinite(err).all()


# --------------------------------------------------------------------------
# four cards


def phase_four_kernel(mesh, rollout, worlds_per_device, t_total, card="",
                      cfg=None):
    """World-parallel rollout over the mesh against one device on the same
    worlds and noise: worlds are independent, so the results are equal."""
    import jax
    import numpy as np

    from live_ekf_slam_tpu.config import Config
    from live_ekf_slam_tpu.ops import fused_rollout as fr
    from live_ekf_slam_tpu.parallel import mesh as pmesh

    n_dev = mesh.devices.size
    batch = n_dev * worlds_per_device
    cfg = cfg or Config(num_iterations=t_total)
    lms, cmds = make_inputs(cfg, batch)
    noise = jax.jit(lambda k: fr.rollout_noise(k, batch, t_total,
                                               lms.shape[1]))(
        jax.random.PRNGKey(5))
    sh = pmesh.world_sharding(mesh)
    args_sh = [jax.device_put(a, sh) for a in (lms, cmds, noise)]
    sharded = jax.jit(lambda l, c, n: fr.fused_ekf_rollout_sharded(
        cfg, l, c, n, mesh, rollout=rollout))
    single = jax.jit(lambda l, c, n: rollout(cfg, l, c, n))
    t_sh, out_sh = timed(sharded, *args_sh)
    t_1, out_1 = timed(single, lms, cmds, noise)
    log(f"rollout at {batch} worlds x T={t_total}: {n_dev} devices "
        f"{median(t_sh)!r} s, one device {median(t_1)!r} s (median of "
        f"{REPS}); times {t_sh!r} / {t_1!r}; card {card}")
    for k in ("err_sum", "err_max", "true_pose", "x", "P", "seen"):
        np.testing.assert_array_equal(np.asarray(out_sh[k]),
                                      np.asarray(out_1[k]), err_msg=k)
    log(f"{n_dev}-device rollout equals the one-device rollout bit for bit "
        f"(err_sum, err_max, true_pose, x, P, seen)")


def phase_four_xla(mesh, worlds_per_device, t_total, card="", cfg=None):
    """The XLA step with world-sharded inputs (parallel/mesh.py) and the
    metric all-reduce, against the same rollout on one device."""
    import jax
    import numpy as np

    from live_ekf_slam_tpu.config import Config
    from live_ekf_slam_tpu.parallel import mesh as pmesh

    n_dev = mesh.devices.size
    batch = n_dev * worlds_per_device
    cfg = cfg or Config(num_iterations=t_total)
    lms, cmds = make_inputs(cfg, batch)
    keys = jax.random.split(jax.random.PRNGKey(6), batch)
    per_world = xla_rollout(cfg, t_total)

    def rollout(lms, cmds, keys):
        err = per_world(lms, cmds, keys)
        return err, pmesh.mean_over_worlds(err)

    sh, rep = pmesh.world_sharding(mesh), pmesh.replicated(mesh)
    args_sh = [jax.device_put(a, sh) for a in (lms, cmds, keys)]
    sharded = jax.jit(rollout, in_shardings=(sh, sh, sh),
                      out_shardings=(sh, rep)).lower(*args_sh).compile()
    assert "all-reduce" in sharded.as_text(), "no all-reduce in the program"
    t_sh, (err_sh, mean_sh) = timed(sharded, *args_sh)
    t_1, (err_1, mean_1) = timed(jax.jit(rollout), lms, cmds, keys)
    err_sh, err_1 = np.asarray(err_sh), np.asarray(err_1)
    d = float(np.max(np.abs(err_sh - err_1)))
    log(f"xla step at {batch} worlds x T={t_total}: {n_dev} devices "
        f"{median(t_sh)!r} s, one device {median(t_1)!r} s; all-reduced "
        f"mean err {float(mean_sh)!r} vs {float(mean_1)!r}; max per-world "
        f"|d| {d!r} (tol 1e-5); card {card}")
    assert np.isfinite(err_1).all()
    np.testing.assert_allclose(err_sh, err_1, rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(mean_sh), float(mean_1), rtol=1e-5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU world-parallel path")
    args = ap.parse_args(argv)
    want = 4 if args.four_cards else 1

    try:
        card = nvidia_smi()
    except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
        card = None
        smi_error = repr(e)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"no GPU found: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind}); this check needs a CUDA GPU")
        return 2
    if card is None:
        raise RuntimeError(f"cannot read the card with nvidia-smi: {smi_error}")
    if len(jax.devices()) < want:
        log(f"--four-cards needs 4 GPUs; JAX found {len(jax.devices())}")
        return 2

    from live_ekf_slam_tpu.utils.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    log(f"devices: {jax.devices()}")
    if args.four_cards:
        from live_ekf_slam_tpu.ops.fused_rollout import fused_ekf_rollout
        from live_ekf_slam_tpu.parallel import mesh as pmesh

        mesh = pmesh.make_mesh(4)
        with phase("four cards: fused rollout"):
            phase_four_kernel(mesh, fused_ekf_rollout, WORLDS, STEPS, card)
        with phase("four cards: sharded xla step + all-reduce"):
            phase_four_xla(mesh, 1024, 250, card)
    else:
        with phase("cli monte_carlo (xla path)"):
            xla_mean = phase_cli()
        with phase("runner impl=fused"):
            phase_runner(xla_mean)
        with phase("kernel vs plain reference"):
            phase_kernel(card)
        with phase("pose-graph streams (kernel emit_traj)"):
            phase_streams()
        with phase("xla ukf_slam timing"):
            phase_ukf(card)

    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
