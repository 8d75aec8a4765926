"""Multi-device scaling: world-batch data parallelism over a device mesh.

The reference is a single-robot, single-process system (SURVEY.md §2.4); this
framework's parallel axis is Monte-Carlo *worlds*: thousands of independent
sim+filter instances vmapped per device and sharded across devices with
`jax.sharding.NamedSharding` over a 1-D mesh. Per-world state is tiny, so no
tensor/pipeline parallelism is needed; the only cross-device communication is
the metric all-reduce (`psum` over the `worlds` axis), which XLA lowers to an
NCCL all-reduce on GPUs (all-to-all NVLink, so the mesh carries no topology).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

WORLD_AXIS = "worlds"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(
            f"make_mesh({n_devices}) requested but only {len(devs)} device(s) "
            f"are available on backend '{jax.default_backend()}'. For a "
            "virtual CPU mesh set XLA_FLAGS=--xla_force_host_platform_device_"
            f"count={n} and JAX_PLATFORMS=cpu before JAX initializes."
        )
    return Mesh(np.asarray(devs[:n]), (WORLD_AXIS,))


def world_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (world-batch) axis across the mesh."""
    return NamedSharding(mesh, P(WORLD_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(tree, mesh: Mesh):
    """Place a batched PyTree with its leading axis sharded over the mesh."""
    sh = world_sharding(mesh)

    def place(x):
        return jax.device_put(x, sh)

    return jax.tree.map(place, tree)


def mean_over_worlds(x, mesh: Mesh | None = None):
    """Cross-chip metric reduction. Under jit with sharded inputs, XLA lowers
    the mean to a local reduction + ICI all-reduce automatically; this helper
    exists to make the collective explicit at call sites."""
    return jnp.mean(x, axis=0)


def sharded_step(step_fn, mesh: Mesh):
    """Wrap a vmapped step so its batch axes are pinned to the mesh.

    step_fn: (carry_batch, inp_batch) -> (carry_batch, out_batch), already
    vmapped over the leading world axis. Returns a jitted function with
    world-sharded inputs/outputs.
    """
    sh = world_sharding(mesh)
    return jax.jit(
        step_fn,
        in_shardings=(sh, sh),
        out_shardings=(sh, sh),
    )
