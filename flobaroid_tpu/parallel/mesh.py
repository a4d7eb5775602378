"""Multi-chip sample-axis sharding.

The reference's only parallelism is host multiprocessing (Optuna worker
processes, a gradient pool; SURVEY §2.9). Here it is SPMD over a
jax.sharding.Mesh: trajectory samples are the big axis of this problem
family, so every sample-parallel reduction (Gram accumulation,
D-optimality objective terms) shards the sample axis over the mesh's
'samples' axis and reduces with a psum across devices. The parameter
space (<= ~500 columns) is replicated — collectives stay O(P^2), tiny
next to the sharded regressor work. The mesh is flat: every device
reaches every other at the same rate.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "samples") -> Mesh:
    """A 1-D mesh over the first n_devices devices (all when None).
    Asking for more devices than are visible is an error: a sharding
    option (shardSamples / shardCandidates) never runs unsharded."""
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"mesh axis '{axis}' needs {n_devices} devices but only "
                f"{len(devs)} are visible; lower shardSamples / "
                f"shardCandidates to at most {len(devs)}"
            )
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def shard_batch(mesh: Mesh, *arrays, axis: str = "samples"):
    """Place arrays with their leading (sample) axis sharded over the mesh."""
    out = []
    for a in arrays:
        spec = P(axis, *([None] * (a.ndim - 1)))
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return tuple(out)


def pad_to_multiple(a: np.ndarray, m: int):
    """Zero-pad the leading axis to a multiple of m (returns array, n_valid)."""
    n = a.shape[0]
    r = (-n) % m
    if r == 0:
        return a, n
    pad = np.zeros((r,) + a.shape[1:], dtype=a.dtype)
    return np.concatenate([a, pad], axis=0), n


def sharded_gram_fn(engine, mesh: Mesh, floating: bool = False, axis: str = "samples"):
    """Build a jitted function computing (Y^T Y, Y^T tau) with the sample
    axis sharded over `mesh`. Inputs: Q, DQ, DDQ (N,n) [+ base args],
    tau (N, rows). The partial Grams are summed with a psum."""

    def local(Q, DQ, DDQ, TAU, BR=None, BV=None, BA=None):
        if floating:
            Y = engine.regressor_batch(Q, DQ, DDQ, BR, BV, BA)
        else:
            Y = engine.regressor_batch(Q, DQ, DDQ)
        P_ = Y.shape[-1]
        Yf = Y.reshape(-1, P_)
        tf = TAU.reshape(-1)
        G = jnp.einsum("mp,mq->pq", Yf, Yf, precision=jax.lax.Precision.HIGHEST)
        g = jnp.einsum("mp,m->p", Yf, tf, precision=jax.lax.Precision.HIGHEST)
        return jax.lax.psum(G, axis), jax.lax.psum(g, axis)

    n_in = 7 if floating else 4
    specs_in = tuple(
        P(axis, *([None] * extra)) for extra in ([1, 1, 1, 1, 2, 1, 1][:n_in])
    )
    spec_rep = P()

    if floating:
        fn = jax.jit(
            jax.shard_map(
                lambda Q, DQ, DDQ, TAU, BR, BV, BA: local(Q, DQ, DDQ, TAU, BR, BV, BA),
                mesh=mesh,
                in_specs=specs_in,
                out_specs=(spec_rep, spec_rep),
            )
        )
    else:
        fn = jax.jit(
            jax.shard_map(
                lambda Q, DQ, DDQ, TAU: local(Q, DQ, DDQ, TAU),
                mesh=mesh,
                in_specs=specs_in,
                out_specs=(spec_rep, spec_rep),
            )
        )
    return fn
