"""Fused sim + EKF-SLAM / RI-EKF-SLAM Monte-Carlo rollout.

Two implementations of one algorithm, kept side by side:

* ``fused_ekf_rollout``: a CUDA kernel for Hopper (ops/ekf_rollout.cu),
  called through ``jax.ffi``. One warp owns one world for all T ticks and
  keeps its covariance in shared memory, so device memory carries only the
  command and noise streams in and the final state out. It runs on a CUDA
  GPU; ``interpret=True`` runs the same source built for the CPU instead,
  which is how the CPU tests check the kernel's algebra.
* ``reference_ekf_rollout``: the same per-tick algebra in plain ``jnp``,
  ``vmap`` over worlds and ``lax.scan`` over T. XLA compiles it for any
  backend. The CPU tests hold it to the float64 oracle, and the GPU check
  (chip_smoke.py) holds the kernel to it.

The algebra (vs the reference algorithms in sim_node.py:209-250 and
ekf.cpp:37-178):

* landmark slot == landmark id. The EKF equations are equivariant under a
  permutation of the state, so pinning each landmark to the slot of its id
  (instead of the reference's discovery order) gives the same estimates up
  to reordering, and every index is static. Requires known landmark ids
  (the default; data association runs on the XLA path).
* P is kept exactly symmetric (the kernel stores its lower triangle; the
  reference mirrors the lower triangle after every write), so H P is read
  from the same columns as P H^T. An asymmetric P lets the fp32 rounding
  residue P - P^T grow through the update's one-sided product.
* H is never materialized: its rows have <= 5 nonzeros at static indices,
  so P H^T is a 4/5-term combination of covariance columns and the
  downdate is one rank-2 pass.
* the predict F P F^T is two rank-1 row and column updates
  (F = I + u e2^T with two nonzeros in u): O(D), not O(D^2).
* sim noise is injected: ``noise[b, t] = (u_d, u_h, u_r[0:N], u_b[0:N])``
  in [-1, 1) (``rollout_noise``), scaled to U(-V, V) / U(-W, W) as in
  sim_node.py:216-217,246-249. The closed-form sim (sim/streams.py) emits
  the same layout, so a rollout can replay its world exactly.

Compat quirks honored: noise V/W swap (via cfg.filter_noise()),
stale-landmark linearization (ekf.cpp:115-129), unwrapped bearing
innovation (ekf.cpp:131). The RI-EKF (models/iekf.py; docs/FILTERS.md)
ignores the two EKF linearization quirks.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from live_ekf_slam_tpu.config import Config
from live_ekf_slam_tpu.core.noise import (
    calibrated_meas_vars,
    motion_moments,
    use_calibrated,
)
from live_ekf_slam_tpu.utils.geometry import wrap_angle

# Initial pose covariance diag (ekf.cpp:11-18).
_P0 = (0.01 * 0.01, 0.01 * 0.01, 0.005 * 0.005)

FILTER_KINDS = ("ekf", "iekf")


def rollout_noise(key, batch: int, t_total: int, n_lm: int):
    """(B, T, 2 + 2N) uniform draws in [-1, 1): the rollout's sim noise."""
    return jax.random.uniform(
        key, (batch, t_total, 2 + 2 * n_lm), jnp.float32, -1.0, 1.0
    )


class _Consts(NamedTuple):
    """Static per-config constants; field order is the kernel's params[]
    layout (ops/ekf_rollout.cu, enum Param)."""

    v00s: float  # sim half-widths, scaled by sim_noise_scale
    v11s: float
    w00s: float
    w11s: float
    v00f: float  # filter variances
    v11f: float
    w00f: float
    w11f: float
    v_d: float   # filter noise means
    v_th: float
    w_r: float
    w_b: float
    d_max: float
    th_max: float
    r_max: float
    fov_min: float
    fov_max: float
    x0: float
    y0: float
    yaw0: float
    stale: float
    wrap_innov: float
    calibrated: float
    iekf: float
    v00: float   # unscaled process half-widths (clip-aware moments)
    v11: float


def _consts(cfg: Config, filter_kind: str) -> _Consts:
    (v00f, v11f), (w00f, w11f) = cfg.filter_noise()
    calibrated = use_calibrated(cfg)
    if calibrated:
        # true U(-W, W) measurement variances (core/noise.py); the process
        # moments are per-tick (clip-aware) and computed inside the tick
        w00f, w11f = calibrated_meas_vars(cfg)
    nz = cfg.sim_noise_scale
    pn, sn = cfg.process_noise, cfg.sensing_noise
    com, vis = cfg.constraints.commands, cfg.constraints.vision
    x0, y0, yaw0 = cfg.init_pose
    return _Consts(
        pn.V_00 * nz, pn.V_11 * nz, sn.W_00 * nz, sn.W_11 * nz,
        v00f, v11f, w00f, w11f,
        pn.v_d, pn.v_th, sn.w_r, sn.w_b,
        com.d_max, com.th_max, vis.range_max, vis.fov_min, vis.fov_max,
        x0, y0, yaw0,
        float(cfg.compat.ekf_stale_landmarks),
        float(not cfg.compat.ekf_unwrapped_innovation),
        float(calibrated),
        float(filter_kind == "iekf"),
        pn.V_00, pn.V_11,
    )


def _check_inputs(cfg: Config, landmarks, cmds, noise, filter_kind: str):
    if not cfg.constraints.measurements.landmark_id_is_known:
        raise ValueError("fused rollout requires known landmark ids")
    if filter_kind not in FILTER_KINDS:
        raise ValueError(f"filter_kind must be one of {FILTER_KINDS}")
    b, n_lm, two = landmarks.shape
    if two != 2 or cmds.shape[0] != b or cmds.shape[2] != 2:
        raise ValueError(
            f"expected landmarks (B, N, 2) and cmds (B, T, 2); got "
            f"{landmarks.shape}, {cmds.shape}"
        )
    want = (b, cmds.shape[1], 2 + 2 * n_lm)
    if tuple(noise.shape) != want:
        raise ValueError(f"noise must be (B, T, 2 + 2N) = {want}; got {noise.shape}")


def _results(err_sum, err_max, true_pose, x, p, seen, traj=None):
    res = {
        "err_sum": err_sum,
        "err_max": err_max,
        "true_pose": true_pose,
        "x": x,
        "P": p,
        "seen": seen > 0.5,
    }
    if traj is not None:
        res["est_traj"] = traj[..., 0:3]
        res["true_traj"] = traj[..., 3:6]
    return res


# --------------------------------------------------------------------------
# plain-JAX reference


def _ekf_update(k: _Consts, x, xs, p, li, rn, bn):
    xv, yv, thv = x[0], x[1], x[2]
    src = xs if k.stale else x
    ddx = src[li] - xv
    ddy = src[li + 1] - yv
    d2 = jnp.maximum(ddx * ddx + ddy * ddy, 1e-12)
    dist = jnp.sqrt(d2)
    a_r, b_r = ddx / dist, ddy / dist
    a_b, b_b = ddy / d2, ddx / d2
    c0, c1, c2 = p[:, 0], p[:, 1], p[:, 2]
    cl0, cl1 = p[:, li], p[:, li + 1]
    pr = (cl0 - c0) * a_r + (cl1 - c1) * b_r
    pb = (c0 - cl0) * a_b + (cl1 - c1) * b_b - c2
    s00 = (-a_r * pr[0] - b_r * pr[1] + a_r * pr[li] + b_r * pr[li + 1]) + k.w00f
    s01 = -a_r * pb[0] - b_r * pb[1] + a_r * pb[li] + b_r * pb[li + 1]
    s10 = a_b * pr[0] - b_b * pr[1] - pr[2] - a_b * pr[li] + b_b * pr[li + 1]
    s11 = (a_b * pb[0] - b_b * pb[1] - pb[2] - a_b * pb[li]
           + b_b * pb[li + 1]) + k.w11f
    k0, k1 = _gain(pr, pb, s00, s01, s10, s11)
    ang_lm = wrap_angle(jnp.arctan2(ddy, ddx) - thv)
    nu_r = rn - dist - k.w_r
    nu_b = bn - ang_lm - k.w_b
    if k.wrap_innov:
        nu_b = wrap_angle(nu_b)
    x_new = x + k0 * nu_r + k1 * nu_b
    x_new = x_new.at[2].set(wrap_angle(x_new[2]))
    return x_new, _downdate(p, k0, k1, pr, pb)


def _iekf_update(k: _Consts, x, p, li, rn, bn):
    xv, yv, thv = x[0], x[1], x[2]
    c1, s1 = _bearing_dir(thv, bn)
    rt00, rt01, rt11 = _rtil(k, rn, c1, s1)
    pr = p[:, li] - p[:, 0]
    pb = p[:, li + 1] - p[:, 1]
    s00 = pr[li] - pr[0] + rt00
    s01 = pb[li] - pb[0] + rt01
    s10 = pr[li + 1] - pr[1] + rt01
    s11 = pb[li + 1] - pb[1] + rt11
    k0, k1 = _gain(pr, pb, s00, s01, s10, s11)
    nu0 = rn * c1 - (x[li] - xv)
    nu1 = rn * s1 - (x[li + 1] - yv)
    xi = k0 * nu0 + k1 * nu1
    # exp retraction (models/iekf._retract): rotate every translation pair
    # by R(dth) and add V(dth) xi
    dth = xi[2]
    cd, sd = jnp.cos(dth), jnp.sin(dth)
    small = jnp.abs(dth) < 1e-6
    dsafe = jnp.where(small, 1.0, dth)
    va = jnp.where(small, 1.0 - dth * dth / 6.0, sd / dsafe)
    vb = jnp.where(small, 0.5 * dth, (1.0 - cd) / dsafe)
    lxs, lys = x[3::2], x[4::2]
    kx, ky = xi[3::2], xi[4::2]
    new_lx = va * kx - vb * ky + cd * lxs - sd * lys
    new_ly = vb * kx + va * ky + sd * lxs + cd * lys
    pose = jnp.stack([
        va * xi[0] - vb * xi[1] + cd * xv - sd * yv,
        vb * xi[0] + va * xi[1] + sd * xv + cd * yv,
        wrap_angle(thv + dth),
    ])
    x_new = jnp.concatenate(
        [pose, jnp.stack([new_lx, new_ly], axis=1).reshape(-1)]
    )
    return x_new, _downdate(p, k0, k1, pr, pb)


def _insert(k: _Consts, iekf: bool, x, p, li, rn, bn):
    xv, yv, thv = x[0], x[1], x[2]
    p00, p01, p11 = p[0, 0], p[0, 1], p[1, 1]
    if iekf:
        # eta_new = eta_p + Rhat n: new rows copy the vehicle-position rows
        c1, s1 = _bearing_dir(thv, bn)
        sx, sy = xv + rn * c1, yv + rn * s1
        rt00, rt01, rt11 = _rtil(k, rn, c1, s1)
        b00, b01, b11 = p00 + rt00, p01 + rt01, p11 + rt11
        nr0, nr1 = p[0], p[1]
    else:
        tb = thv + bn
        ct, st = jnp.cos(tb), jnp.sin(tb)
        sx, sy = xv + rn * ct, yv + rn * st
        ga, gb = -rn * st, rn * ct  # G_x(0,2) = G_z(0,1), G_x(1,2)
        p02, p12, p22 = p[0, 2], p[1, 2], p[2, 2]
        b00 = (p00 + 2.0 * ga * p02 + ga * ga * p22
               + ct * ct * k.w00f + ga * ga * k.w11f)
        b01 = (p01 + gb * p02 + ga * p12 + ga * gb * p22
               + ct * st * k.w00f + ga * gb * k.w11f)
        b11 = (p11 + 2.0 * gb * p12 + gb * gb * p22
               + st * st * k.w00f + gb * gb * k.w11f)
        nr0 = p[0] + ga * p[2]
        nr1 = p[1] + gb * p[2]
    x_new = x.at[li].set(sx).at[li + 1].set(sy)
    p_new = (
        p.at[li].set(nr0).at[li + 1].set(nr1)
        .at[:, li].set(nr0).at[:, li + 1].set(nr1)
        .at[li, li].set(b00).at[li, li + 1].set(b01)
        .at[li + 1, li].set(b01).at[li + 1, li + 1].set(b11)
    )
    return x_new, p_new


def _bearing_dir(thv, bn):
    cth, sth = jnp.cos(thv), jnp.sin(thv)
    cbn, sbn = jnp.cos(bn), jnp.sin(bn)
    return cth * cbn - sth * sbn, sth * cbn + cth * sbn  # cos/sin(th + b)


def _rtil(k: _Consts, rn, c1, s1):
    """Rtil = Rhat Jpc W Jpc^T Rhat^T via the unit bearing (c1, s1)."""
    rr2 = rn * rn
    return (
        k.w00f * c1 * c1 + k.w11f * rr2 * s1 * s1,
        (k.w00f - k.w11f * rr2) * c1 * s1,
        k.w00f * s1 * s1 + k.w11f * rr2 * c1 * c1,
    )


def _gain(pr, pb, s00, s01, s10, s11):
    det = s00 * s11 - s01 * s10
    det = jnp.where(jnp.abs(det) > 1e-20, det, 1.0)
    i00, i01, i10, i11 = s11 / det, -s01 / det, -s10 / det, s00 / det
    return pr * i00 + pb * i10, pr * i01 + pb * i11


def _downdate(p, k0, k1, pr, pb):
    """P -= K (H P) with H P read from the P H^T columns (P symmetric)."""
    return _sym(p - k0[:, None] * pr[None, :] - k1[:, None] * pb[None, :])


def _sym(p):
    """Mirror the lower triangle: the kernel stores only that triangle."""
    d = p.shape[0]
    return jnp.where(np.tril(np.ones((d, d), bool)), p, p.T)


def _reference_world(cfg: Config, filter_kind: str, emit_traj: bool,
                     lms, cmds, noise):
    k = _consts(cfg, filter_kind)
    iekf = filter_kind == "iekf"
    n_lm = lms.shape[0]
    d = 3 + 2 * n_lm
    x = jnp.zeros(d, jnp.float32).at[:3].set(
        jnp.asarray([k.x0, k.y0, k.yaw0], jnp.float32))
    p = jnp.zeros((d, d), jnp.float32).at[:3, :3].set(
        jnp.diag(jnp.asarray(_P0, jnp.float32)))
    truth = jnp.asarray([k.x0, k.y0, k.yaw0], jnp.float32)
    carry0 = (x, p, jnp.zeros(n_lm, bool), truth,
              jnp.float32(0.0), jnp.float32(0.0))

    def tick(carry, inp):
        x, p, seen, truth, err_sum, err_max = carry
        cmd, u = inp
        fwd, ang = cmd[0], cmd[1]
        # ---- truth propagation (sim_node.py:216-222)
        d_n = jnp.clip(fwd + k.v00s * u[0], 0.0, k.d_max)
        h_n = jnp.clip(ang + k.v11s * u[1], -k.th_max, k.th_max)
        tx = truth[0] + d_n * jnp.cos(truth[2])
        ty = truth[1] + d_n * jnp.sin(truth[2])
        tth = truth[2] + h_n  # deliberately unwrapped
        # ---- sensing (sim_node.py:228-250)
        dxl = lms[:, 0] - tx
        dyl = lms[:, 1] - ty
        r_true = jnp.sqrt(dxl * dxl + dyl * dyl)
        beta = wrap_angle(jnp.arctan2(dyl, dxl) - tth)
        vis = (r_true <= k.r_max) & (beta > k.fov_min) & (beta < k.fov_max)
        rn_all = r_true + k.w00s * u[2:2 + n_lm]
        bn_all = beta + k.w11s * u[2 + n_lm:2 + 2 * n_lm]
        # ---- predict (ekf.cpp:41-61 / models/iekf.py)
        th = x[2]
        c, s = jnp.cos(th), jnp.sin(th)
        if k.calibrated:
            eff_d, eff_th, var_d, var_th = motion_moments(cfg, fwd, ang)
            jac_d = eff_d
        else:
            eff_d, eff_th = fwd + k.v_d, ang + k.v_th
            var_d, var_th = k.v00f, k.v11f
            jac_d = fwd  # F_x from the raw command (ekf.cpp:47-50)
        if iekf:
            sf = seen.astype(jnp.float32)
            g_lm = jnp.stack([sf * x[4::2], -sf * x[3::2]], axis=1)
            g = jnp.concatenate([
                jnp.stack([jac_d * s + x[1], -jac_d * c - x[0],
                           jnp.float32(1.0)]),
                g_lm.reshape(-1),
            ])
            p = p + var_th * g[:, None] * g[None, :]
            p = (p.at[0, 0].add(c * c * var_d).at[0, 1].add(s * c * var_d)
                 .at[1, 0].add(s * c * var_d).at[1, 1].add(s * s * var_d))
        else:
            u0, u1 = -jac_d * s, jac_d * c
            row2 = p[2]
            p = p.at[0].add(u0 * row2).at[1].add(u1 * row2)
            col2 = p[:, 2]
            p = p.at[:, 0].add(col2 * u0).at[:, 1].add(col2 * u1)
            p = (p.at[0, 0].add(c * c * var_d).at[0, 1].add(s * c * var_d)
                 .at[1, 0].add(s * c * var_d).at[1, 1].add(s * s * var_d)
                 .at[2, 2].add(var_th))
        p = _sym(p)
        x = x.at[0].add(eff_d * c).at[1].add(eff_d * s)
        x = x.at[2].set(wrap_angle(th + eff_th))
        xs = x  # tick-start snapshot (stale-landmark quirk)
        # ---- sequential per-landmark update / insertion (ekf.cpp:73-174)
        for j in range(n_lm):
            li = 3 + 2 * j
            rn, bn = rn_all[j], bn_all[j]
            m_u = vis[j] & seen[j]
            m_i = vis[j] & ~seen[j]
            if iekf:
                xn, pn = _iekf_update(k, x, p, li, rn, bn)
            else:
                xn, pn = _ekf_update(k, x, xs, p, li, rn, bn)
            x = jnp.where(m_u, xn, x)
            p = jnp.where(m_u, pn, p)
            xn, pn = _insert(k, iekf, x, p, li, rn, bn)
            x = jnp.where(m_i, xn, x)
            p = jnp.where(m_i, pn, p)
            seen = seen.at[j].set(seen[j] | vis[j])
        # ---- error metric (plotting_node.py:195-218), online
        ex, ey = x[0] - tx, x[1] - ty
        e = jnp.sqrt(ex * ex + ey * ey)
        truth = jnp.stack([tx, ty, tth])
        out = jnp.concatenate([x[:3], truth]) if emit_traj else None
        return (x, p, seen, truth, err_sum + e,
                jnp.maximum(err_max, e)), out

    (x, p, seen, truth, err_sum, err_max), traj = jax.lax.scan(
        tick, carry0, (cmds, noise)
    )
    return err_sum, err_max, truth, x, p, seen.astype(jnp.float32), traj


@functools.partial(
    jax.jit, static_argnames=("cfg", "emit_traj", "filter_kind")
)
def reference_ekf_rollout(cfg: Config, landmarks, cmds, noise,
                          emit_traj: bool = False, filter_kind: str = "ekf"):
    """Plain-JAX rollout: the kernel's algebra as vmap(scan(tick)).

    landmarks: (B, N, 2) true maps; cmds: (B, T, 2) commanded odometry;
    noise: (B, T, 2 + 2N) from ``rollout_noise``. Returns a dict with
    per-world err_sum / err_max (running max of the instantaneous error),
    final true pose, filter state x (B, D) and P (B, D, D), seen mask, and
    with emit_traj the per-tick est_traj / true_traj (B, T, 3).
    """
    _check_inputs(cfg, landmarks, cmds, noise, filter_kind)
    one = functools.partial(_reference_world, cfg, filter_kind, emit_traj)
    outs = jax.vmap(one)(
        jnp.asarray(landmarks, jnp.float32),
        jnp.asarray(cmds, jnp.float32),
        jnp.asarray(noise, jnp.float32),
    )
    return _results(*outs)


# --------------------------------------------------------------------------
# CUDA kernel

_SRC = Path(__file__).with_name("ekf_rollout.cu")
# built into the checkout's build/ directory (listed in .gitignore)
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# the host build (interpret mode): the same source as C++ for the CPU
_CXX_FLAGS = ("-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC")
_TARGETS = {
    False: ("les_ekf_rollout", "les_ekf_rollout_traj"),
    True: ("les_ekf_rollout_host", "les_ekf_rollout_traj_host"),
}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the fused rollout kernel is "
            f"built from {_SRC.name} at first use"
        )
    return found


def _cxx() -> str:
    found = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if found is None:
        raise RuntimeError(
            "no C++ compiler found (set CXX): interpret mode builds "
            f"{_SRC.name} for the host at first use"
        )
    return found


def build_kernel_library(host: bool = False) -> Path:
    """Compile ops/ekf_rollout.cu once per source version; returns the .so.

    host=False builds the CUDA kernel with nvcc; host=True builds the same
    source with the C++ compiler for interpret mode. The file name carries
    a hash of the source and flags, so an edited kernel is rebuilt and a
    stale library is never loaded.
    """
    flags = _CXX_FLAGS if host else _NVCC_FLAGS
    tag = hashlib.sha256(
        _SRC.read_bytes() + " ".join(flags).encode()
    ).hexdigest()[:16]
    kind = "host" if host else "sm90a"
    lib = _BUILD_DIR / f"libekf_rollout_{kind}_{tag}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(lib.name + f".{os.getpid()}.tmp")
    cmd = [_cxx() if host else _nvcc(), *flags, "-I", jax.ffi.include_dir(),
           "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed:\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def _register_kernel(host: bool) -> None:
    lib = ctypes.cdll.LoadLibrary(str(build_kernel_library(host)))
    for name, sym in zip(_TARGETS[host], (lib.EkfRollout, lib.EkfRolloutTraj)):
        jax.ffi.register_ffi_target(
            name, jax.ffi.pycapsule(sym), platform="cpu" if host else "CUDA"
        )


def kernel_params(cfg: Config, filter_kind: str = "ekf") -> np.ndarray:
    """The kernel's params[] vector (float32, _Consts field order)."""
    return np.asarray(_consts(cfg, filter_kind), np.float32)


@functools.partial(
    jax.jit, static_argnames=("cfg", "emit_traj", "filter_kind", "interpret")
)
def fused_ekf_rollout(cfg: Config, landmarks, cmds, noise,
                      emit_traj: bool = False, filter_kind: str = "ekf",
                      interpret: bool = False):
    """The rollout as one CUDA kernel launch; same contract as
    ``reference_ekf_rollout``. Raises off a CUDA GPU.

    interpret=True runs the kernel's host build instead (the same source
    compiled for the CPU, one lane per warp; see ops/ekf_rollout.cu), on
    the CPU backend only. Tests use it; nothing else should.
    """
    _check_inputs(cfg, landmarks, cmds, noise, filter_kind)
    platform = jax.default_backend()
    if interpret and platform != "cpu":
        raise RuntimeError(
            "interpret=True runs the kernel's host build and needs the CPU "
            f"backend; this process runs on {platform!r}"
        )
    if not interpret and platform != "gpu":
        raise RuntimeError(
            "fused_ekf_rollout is a CUDA kernel and needs a GPU backend; "
            f"this process runs on {platform!r} (interpret=True runs its "
            "host build; reference_ekf_rollout is the same algebra in plain "
            "JAX)"
        )
    _register_kernel(interpret)
    b, n_lm, _ = landmarks.shape
    t_total = cmds.shape[1]
    d = 3 + 2 * n_lm
    f32 = jnp.float32
    out_types = [
        jax.ShapeDtypeStruct((b, 5), f32),   # err_sum, err_max, true pose
        jax.ShapeDtypeStruct((b, d), f32),
        jax.ShapeDtypeStruct((b, d, d), f32),
        jax.ShapeDtypeStruct((b, n_lm), f32),
    ]
    if emit_traj:
        out_types.append(jax.ShapeDtypeStruct((b, t_total, 6), f32))
    outs = jax.ffi.ffi_call(_TARGETS[interpret][int(emit_traj)], out_types)(
        jnp.asarray(kernel_params(cfg, filter_kind)),
        jnp.asarray(landmarks, f32),
        jnp.asarray(cmds, f32),
        jnp.asarray(noise, f32),
    )
    stats = outs[0]
    return _results(stats[:, 0], stats[:, 1], stats[:, 2:5], *outs[1:])


def fused_ekf_rollout_sharded(cfg: Config, landmarks, cmds, noise, mesh,
                              rollout=fused_ekf_rollout, **kw):
    """World-parallel rollout over a 1-D device mesh.

    Each device runs ``rollout`` (the kernel by default, or
    ``reference_ekf_rollout``) on its shard of worlds. Worlds are
    independent and the noise is sharded with them, so the result equals a
    one-device run on the same inputs; reductions over the results ride
    the mesh afterwards.
    """
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    if landmarks.shape[0] % n_dev != 0:
        raise ValueError(
            f"batch {landmarks.shape[0]} not divisible by mesh size {n_dev}"
        )
    keys = ["err_sum", "err_max", "true_pose", "x", "P", "seen"]
    if kw.get("emit_traj"):
        keys += ["est_traj", "true_traj"]

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(P(axis),) * 3,
        out_specs={k: P(axis) for k in keys},
        # the FFI call's outputs carry no varying-mesh-axis info; the
        # per-device rollouts are fully independent
        check_vma=False,
    )
    def run(lms_shard, cmds_shard, noise_shard):
        return rollout(cfg, lms_shard, cmds_shard, noise_shard, **kw)

    return run(landmarks, cmds, noise)
