"""Platform plumbing: what the program needs from its installation, where it
keeps its compile cache, and how it refuses to run the GPU path elsewhere."""

import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from live_ekf_slam_tpu.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code, env=None, cwd=REPO):
    full = dict(os.environ, **(env or {}))
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=cwd, env=full, timeout=300)


def test_runner_import_needs_neither_flax_nor_yaml():
    r = _python(
        "import sys, live_ekf_slam_tpu.eval.runner\n"
        "bad = [m for m in ('flax', 'yaml') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    assert r.returncode == 0, r.stderr[-2000:]


def test_compile_cache_honours_env_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the helper sets nothing else, and
    compiled programs land in that directory."""
    cache = tmp_path / "cache"
    r = _python(
        "import jax, jax.numpy as jnp\n"
        "from live_ekf_slam_tpu.utils.compile_cache import "
        "enable_compile_cache\n"
        "print(enable_compile_cache())\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
        "jax.jit(lambda x: jnp.sin(x) @ x.T)(jnp.ones((8, 8)))"
        ".block_until_ready()\n",
        env={"JAX_COMPILATION_CACHE_DIR": str(cache),
             "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0",
             "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES": "0"},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    returned, configured = r.stdout.split()[:2]
    assert returned == configured == str(cache)
    assert cache.is_dir() and any(cache.iterdir())


def test_compile_cache_default_is_fixed_checkout_path():
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax\n"
         "from live_ekf_slam_tpu.utils.compile_cache import "
         "enable_compile_cache\n"
         "print(enable_compile_cache())\n"
         "print(jax.config.jax_compilation_cache_dir)\n"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    want = os.path.join(REPO, ".jax_cache")
    assert r.stdout.split()[:2] == [want, want]
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """No accelerator (or no program beside the script): a non-zero exit and
    no result line."""
    cwd = REPO
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        cwd=cwd, env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=300,
    )
    assert r.returncode != 0
    assert "no GPU found" in r.stdout
    assert '"ok"' not in r.stdout


def test_chip_smoke_comparison_enforces_its_tolerances():
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    b, d, n = 16, 7, 2
    rng = np.random.default_rng(0)
    ref = {
        "err_sum": rng.uniform(50, 150, b).astype(np.float32),
        "err_max": rng.uniform(0.2, 1.0, b).astype(np.float32),
        "true_pose": rng.normal(size=(b, 3)).astype(np.float32),
        "x": rng.normal(size=(b, d)).astype(np.float32),
        "seen": rng.uniform(size=(b, n)) > 0.5,
    }
    cs.compare("ekf", dict(ref), ref, 1000)
    moved = dict(ref, x=ref["x"] + 10 * cs.TOL["x_abs"])
    with pytest.raises(AssertionError):
        cs.compare("ekf", moved, ref, 1000)
    diverged = dict(ref, err_max=np.where(np.arange(b) == 0, np.inf,
                                          ref["err_max"]))
    with pytest.raises(AssertionError):
        cs.compare("ekf", diverged, ref, 1000)


def test_chip_smoke_four_card_phases_on_cpu_mesh():
    """The --four-cards phases, run with the plain reference rollout on four
    virtual CPU devices at a tiny size: sharded equals one device."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from live_ekf_slam_tpu.ops.fused_rollout import reference_ekf_rollout
    from live_ekf_slam_tpu.parallel import mesh as pmesh

    cfg = Config(num_iterations=8).replace(num_landmark_slots=3,
                                           num_meas_slots=3)
    cfg = cfg.replace(map=cfg.map.__class__(num_landmarks=3))
    mesh = pmesh.make_mesh(4)
    cs.phase_four_kernel(mesh, reference_ekf_rollout, 2, 8, cfg=cfg)
    cs.phase_four_xla(mesh, 2, 8, cfg=cfg)


def test_fused_impl_rejects_ukf_and_non_gpu_backends():
    from live_ekf_slam_tpu.eval.runner import (
        run_monte_carlo,
        run_monte_carlo_pg_streams,
    )

    key = jax.random.PRNGKey(0)
    cfg = Config(num_iterations=4)
    with pytest.raises(ValueError, match="UKF filters run with impl='xla'"):
        run_monte_carlo(cfg.replace(filter="ukf_slam"), key, 2, impl="fused")
    with pytest.raises(ValueError, match="impl must be"):
        run_monte_carlo(cfg, key, 2, impl="pallas")
    pg = cfg.replace(filter="pose_graph")
    pg = pg.replace(pose_graph=dataclasses.replace(
        pg.pose_graph, filter_to_compare="ekf_slam"))
    with pytest.raises(ValueError, match="impl must be one of"):
        run_monte_carlo_pg_streams(pg, key, 2, impl="interpret")
    if jax.default_backend() != "gpu":
        with pytest.raises(RuntimeError, match="needs a GPU backend"):
            run_monte_carlo(cfg, key, 2, impl="fused")


def test_bench_refuses_cpu_and_ukf_kernel():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench_mod", os.path.join(REPO, "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    with pytest.raises(SystemExit, match="no fused rollout"):
        bench.rollout_bench("ukf_slam", "kernel", 2, 4, 1, {})
    with pytest.raises(SystemExit, match="use kernel or xla"):
        bench.rollout_bench("ekf_slam", "pallas", 2, 4, 1, {})
    if jax.default_backend() != "gpu":
        with pytest.raises(SystemExit, match="measures the GPU"):
            bench.device_info()


def test_pytree_dataclass_keeps_flax_struct_semantics():
    from live_ekf_slam_tpu.core import pytree

    @pytree.dataclass
    class Pair:
        a: jax.Array
        b: jax.Array
        tag: object = pytree.field(default=None)

    p = Pair(jnp.ones(3), jnp.zeros(3))  # positional construction
    assert p.tag is None
    q = p.replace(b=jnp.full(3, 2.0))
    assert float(q.b[0]) == 2.0 and float(p.b[0]) == 0.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = jnp.zeros(3)
    leaves, tree = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2  # None is an empty subtree
    assert jax.tree_util.tree_unflatten(tree, leaves).b.shape == (3,)
    out = jax.jit(lambda s: s.replace(a=s.a + s.b))(q)
    np.testing.assert_array_equal(np.asarray(out.a), np.full(3, 3.0))
    batched = jax.vmap(lambda s: s.a * 2)(Pair(jnp.ones((4, 3)),
                                               jnp.ones((4, 3))))
    assert batched.shape == (4, 3)

