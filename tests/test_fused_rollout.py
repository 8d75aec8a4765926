"""Tests of the fused sim+EKF rollout: the CUDA kernel and its plain-JAX
reference (ops/fused_rollout.py).

Both are replayed with an injected noise array through a numpy float64
simulation + the reference-equation EKF oracle. Kernel landmark slots are
pinned to ids; the oracle's discovery-order state is compared through the
id permutation (the EKF is permutation-equivariant). The ``rollout``
fixture (conftest.py) runs each such test on the reference everywhere, on
the kernel's host build (``interpret=True``) on the CPU, and on the CUDA
kernel where a GPU is present (marker ``gpu``).
"""

import math
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from live_ekf_slam_tpu.config import CompatConfig, Config
from live_ekf_slam_tpu.ops import fused_rollout as fr
from live_ekf_slam_tpu.sim import maps as sim_maps

from oracle import EKFOracle

B, T, N = 8, 25, 5


def _setup(seed=5, compat=False, b=B):
    cfg = Config(num_iterations=T).replace(
        num_landmark_slots=N, num_meas_slots=N
    )
    if compat:
        cfg = cfg.replace(compat=CompatConfig.all_on())
    cfg = cfg.replace(map=cfg.map.__class__(num_landmarks=N))
    rng = np.random.default_rng(seed)
    lms = sim_maps.random_landmarks_batched(cfg, rng, b)
    t_arr = np.arange(T, dtype=np.float32)
    cmds = np.stack(
        [0.08 + 0 * t_arr, 0.02 * np.sin(t_arr / 5)], axis=-1
    )
    cmds = np.broadcast_to(cmds[None], (b, T, 2)).copy()
    noise = rng.uniform(-1, 1, size=(b, T, 2 + 2 * N)).astype(np.float32)
    return cfg, lms, cmds, noise


def sim_measurements(cfg, lms_w, cmds_w, noise_w):
    """Float64 replay of the rollout's simulator: per-tick true pose and
    id-sorted (id, r, b) measurement lists."""
    v00, v11 = cfg.process_noise.V_00, cfg.process_noise.V_11
    w00, w11 = cfg.sensing_noise.W_00, cfg.sensing_noise.W_11
    n = lms_w.shape[0]
    pose = np.array(cfg.init_pose, np.float64)
    poses, measlists = [], []
    for t in range(cmds_w.shape[0]):
        u = noise_w[t].astype(np.float64)
        d = np.clip(cmds_w[t, 0] + v00 * u[0], 0,
                    cfg.constraints.commands.d_max)
        h = np.clip(
            cmds_w[t, 1] + v11 * u[1],
            -cfg.constraints.commands.th_max,
            cfg.constraints.commands.th_max,
        )
        pose = np.array([
            pose[0] + d * math.cos(pose[2]),
            pose[1] + d * math.sin(pose[2]),
            pose[2] + h,
        ])
        meas = []
        for j in range(n):
            dx, dy = lms_w[j] - pose[:2]
            r = math.hypot(dx, dy)
            beta = math.remainder(math.atan2(dy, dx) - pose[2], 2 * math.pi)
            if (
                r <= cfg.constraints.vision.range_max
                and cfg.constraints.vision.fov_min
                < beta
                < cfg.constraints.vision.fov_max
            ):
                meas.append((j, r + w00 * u[2 + j], beta + w11 * u[2 + n + j]))
        poses.append(pose.copy())
        measlists.append(meas)
    return poses, measlists


def xla_filter_run(cfg, model, lms_w, cmds_w, noise_w):
    """Drive an XLA filter (models/ekf.py or models/iekf.py, each
    oracle-parity-tested) with the id-ordered replayed measurement lists."""
    from live_ekf_slam_tpu.core.types import Measurements

    poses, measlists = sim_measurements(cfg, lms_w, cmds_w, noise_w)
    s = model.init(cfg)
    step = jax.jit(lambda s, cmd, m: model.update(cfg, s, cmd, m))
    err_sum = 0.0
    n_slots = cfg.num_meas_slots
    for t in range(cmds_w.shape[0]):
        ids = np.full(n_slots, -1, np.int32)
        r = np.zeros(n_slots, np.float32)
        b = np.zeros(n_slots, np.float32)
        valid = np.zeros(n_slots, bool)
        for k, (mid, mr, mb) in enumerate(measlists[t]):
            ids[k], r[k], b[k], valid[k] = mid, mr, mb, True
        m = Measurements(
            ids=jnp.asarray(ids), r=jnp.asarray(r), b=jnp.asarray(b),
            valid=jnp.asarray(valid), overflow=jnp.asarray(False),
        )
        s = step(s, jnp.asarray(cmds_w[t], jnp.float32), m)
        xs = np.asarray(s.x)
        err_sum += math.hypot(xs[0] - poses[t][0], xs[1] - poses[t][1])
    return s, poses[-1], err_sum


def _oracle_run(cfg, lms_w, cmds_w, noise_w):
    (v00f, v11f), (w00f, w11f) = cfg.filter_noise()
    o = EKFOracle(
        0, 0, 0, V=(v00f, v11f), W=(w00f, w11f),
        stale_landmarks=cfg.compat.ekf_stale_landmarks,
        unwrapped_innovation=cfg.compat.ekf_unwrapped_innovation,
    )
    poses, measlists = sim_measurements(cfg, lms_w, cmds_w, noise_w)
    err_sum = 0.0
    for t in range(cmds_w.shape[0]):
        o.update((cmds_w[t, 0], cmds_w[t, 1]), measlists[t])
        err_sum += math.hypot(o.x_t[0] - poses[t][0], o.x_t[1] - poses[t][1])
    return o, poses[-1], err_sum


def _run(rollout, cfg, lms, cmds, noise, **kw):
    out = rollout(cfg, jnp.asarray(lms), jnp.asarray(cmds),
                  jnp.asarray(noise), **kw)
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("compat", [False, True])
def test_fused_rollout_matches_oracle_with_replayed_noise(rollout, compat):
    cfg, lms, cmds, noise = _setup(compat=compat)
    out = _run(rollout, cfg, lms, cmds, noise)
    assert out["seen"].sum(axis=1).max() >= 2, "test maps saw <2 landmarks"
    for w in range(B):
        o, pose, err_sum = _oracle_run(cfg, lms[w], cmds[w], noise[w])
        np.testing.assert_allclose(out["true_pose"][w], pose, atol=1e-4)
        assert abs(out["err_sum"][w] - err_sum) < 1e-3 * max(err_sum, 1.0)
        assert set(o.lm_ids) == set(np.where(out["seen"][w])[0])
        perm = [0, 1, 2]
        for sl in range(o.M):
            perm += [3 + 2 * o.lm_ids[sl], 4 + 2 * o.lm_ids[sl]]
        np.testing.assert_allclose(
            out["x"][w][np.array(perm)], o.x_t, atol=2e-4
        )
        np.testing.assert_allclose(
            out["P"][w][np.ix_(perm, perm)], o.P_t, atol=2e-5
        )


def test_fused_iekf_matches_xla_model(rollout):
    from live_ekf_slam_tpu.models import iekf

    cfg, lms, cmds, noise = _setup()
    out = _run(rollout, cfg, lms, cmds, noise, filter_kind="iekf")
    assert out["seen"].sum(axis=1).max() >= 2, "test maps saw <2 landmarks"
    for w in range(B):
        s, pose, err_sum = xla_filter_run(cfg, iekf, lms[w], cmds[w], noise[w])
        np.testing.assert_allclose(out["true_pose"][w], pose, atol=1e-4)
        assert abs(out["err_sum"][w] - err_sum) < 2e-3 * max(err_sum, 1.0)
        sx = np.asarray(s.x)
        np.testing.assert_allclose(out["x"][w][:3], sx[:3], atol=5e-4)
        ids = np.asarray(s.ids)[: int(s.M)]
        assert set(ids.tolist()) == set(np.where(out["seen"][w])[0].tolist())
        for sl, mid in enumerate(ids.tolist()):
            np.testing.assert_allclose(
                out["x"][w][3 + 2 * mid:5 + 2 * mid],
                sx[3 + 2 * sl:5 + 2 * sl],
                atol=5e-4,
            )
        np.testing.assert_allclose(
            out["P"][w][:3, :3], np.asarray(s.P)[:3, :3], atol=5e-4
        )


@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("emit_traj", [False, True])
def test_rollout_output_layout(rollout, b, emit_traj):
    """Any batch size (no block multiple), world-major outputs, symmetric
    P, and the emit_traj streams: (B, T, 3) est / true poses whose last
    tick is the final state."""
    cfg, lms, cmds, noise = _setup(b=b)
    out = _run(rollout, cfg, lms, cmds, noise, emit_traj=emit_traj)
    d = 3 + 2 * N
    shapes = {
        "err_sum": (b,), "err_max": (b,), "true_pose": (b, 3),
        "x": (b, d), "P": (b, d, d), "seen": (b, N),
    }
    if emit_traj:
        shapes.update(est_traj=(b, T, 3), true_traj=(b, T, 3))
    assert {k: v.shape for k, v in out.items()} == shapes
    assert out["seen"].dtype == bool
    np.testing.assert_array_equal(out["P"], np.swapaxes(out["P"], 1, 2))
    if emit_traj:
        np.testing.assert_array_equal(out["est_traj"][:, -1], out["x"][:, :3])
        np.testing.assert_array_equal(out["true_traj"][:, -1],
                                      out["true_pose"])
        err = np.linalg.norm(out["est_traj"][..., :2]
                             - out["true_traj"][..., :2], axis=-1)
        np.testing.assert_allclose(out["err_sum"], err.sum(axis=1),
                                   rtol=1e-5)
        np.testing.assert_allclose(out["err_max"], err.max(axis=1),
                                   rtol=1e-6)


def test_sharded_fused_rollout_matches_single_device(rollout):
    """shard_map over the device mesh: per-device rollouts, identical
    output to one device on the same worlds and noise."""
    from live_ekf_slam_tpu.parallel import mesh as pmesh

    n_dev = min(len(jax.devices()), 4)
    cfg, lms, cmds, noise = _setup(b=2 * n_dev)
    mesh = pmesh.make_mesh(n_dev)
    args = [jnp.asarray(a) for a in (lms, cmds, noise)]
    out_sh = fr.fused_ekf_rollout_sharded(cfg, *args, mesh, rollout=rollout)
    out_1 = rollout(cfg, *args)
    for k in ("err_sum", "x", "P"):
        np.testing.assert_array_equal(np.asarray(out_sh[k]),
                                      np.asarray(out_1[k]))


def test_rollout_rejects_bad_inputs():
    cfg, lms, cmds, noise = _setup(b=2)
    with pytest.raises(ValueError, match="noise must be"):
        fr.reference_ekf_rollout(cfg, lms, cmds, noise[:, :, :-1])
    with pytest.raises(ValueError, match="filter_kind"):
        fr.reference_ekf_rollout(cfg, lms, cmds, noise, filter_kind="ukf")
    unknown = cfg.replace(constraints=cfg.constraints.__class__(
        measurements=cfg.constraints.measurements.__class__(
            landmark_id_is_known=False)))
    with pytest.raises(ValueError, match="known landmark ids"):
        fr.reference_ekf_rollout(unknown, lms, cmds, noise)


def test_kernel_raises_without_gpu():
    """Off a GPU the kernel refuses to run unless the caller asked for
    interpret mode; it never falls back on its own."""
    if jax.default_backend() == "gpu":
        pytest.skip("checks the behaviour off a GPU")
    cfg, lms, cmds, noise = _setup(b=2)
    with pytest.raises(RuntimeError, match="needs a GPU backend"):
        fr.fused_ekf_rollout(cfg, lms, cmds, noise)
    out = fr.fused_ekf_rollout(cfg, lms, cmds, noise, interpret=True)
    assert np.isfinite(np.asarray(out["err_sum"])).all()


def test_kernel_params_match_cuda_layout():
    """The params[] vector the wrapper builds follows the kernel's enum."""
    src = (fr._SRC).read_text()
    body = re.search(r"enum Param \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = [t.strip() for t in body.split(",") if t.strip()]
    assert names[-1] == "kNumParams"
    assert len(names) - 1 == len(fr._Consts._fields)
    cfg = Config().replace(compat=CompatConfig.all_on())
    p = fr.kernel_params(cfg, "iekf")
    assert p.dtype == np.float32 and p.shape == (len(names) - 1,)
    k = dict(zip(fr._Consts._fields, p.tolist()))
    assert k["iekf"] == 1.0 and k["stale"] == 1.0 and k["wrap_innov"] == 0.0
    assert k["d_max"] == pytest.approx(cfg.constraints.commands.d_max)


def test_rollout_noise_layout_and_range():
    u = np.asarray(fr.rollout_noise(jax.random.PRNGKey(0), 64, 50, 3))
    assert u.shape == (64, 50, 8) and u.dtype == np.float32
    assert u.min() >= -1.0 and u.max() < 1.0
    assert abs(u.mean()) < 0.02 and abs(u.var() - 1.0 / 3.0) < 0.02


def test_reference_replays_closed_form_sim_streams():
    """sim/streams.py emits its draws in the rollout's noise layout: a
    rollout fed that noise walks the same true trajectory."""
    from live_ekf_slam_tpu.sim.streams import sim_streams

    cfg, lms, cmds, _ = _setup(b=2)
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    st = jax.vmap(lambda l, c, k: sim_streams(cfg, l, N, c, k))(
        jnp.asarray(lms), jnp.asarray(cmds, jnp.float32), keys)
    out = _run(fr.reference_ekf_rollout, cfg, lms, cmds,
               np.asarray(st["noise_u"]), emit_traj=True)
    np.testing.assert_allclose(out["true_traj"], np.asarray(st["poses_true"]),
                               atol=1e-4)


def test_kernel_source_and_build_dir_are_in_the_checkout():
    """The library is built from the repo's own source into build/, which
    git ignores."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert fr._SRC.exists()
    assert str(fr._BUILD_DIR) == os.path.join(repo, "build")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert "build/" in f.read().split()
