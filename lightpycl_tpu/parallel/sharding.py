"""Multi-chip scale-out: rays sharded over a device mesh, mesh replicated.

Reference parity: the reference is single-process single-device (SURVEY.md
§3 'Distributed comm backend: none'); the scale-out axis required
by BASELINE configs[4] is RAY data parallelism: the ray batch shards over a
1-D `"rays"` mesh axis with `shard_map`, the triangle mesh and materials
replicate to every chip, and the detector histogram + power-conservation
ledger reduce with `psum`. Rays never migrate between chips
(Fresnel-split children stay on their parent's chip), so there is zero
point-to-point traffic — scaling is linear by construction up to compaction
imbalance.

Multi-host: initialize `jax.distributed` before calling; everything here is
plain SPMD over whatever mesh it is handed (DCN only enters via the mesh).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lightpycl_tpu.tracer.config import TraceConfig
from lightpycl_tpu.tracer.rays import DetectorState, Ledger, RayBatch
from lightpycl_tpu.tracer.scene import Scene
from lightpycl_tpu.tracer.step import trace_step

RAY_AXIS = "rays"


def make_ray_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (RAY_AXIS,))


def interleave_rays(rays: RayBatch, n_shards: int) -> RayBatch:
    """Round-robin-permute ray slots so contiguous shard blocks each hold
    every n_shards-th slot: shard s, in-shard slot r gets original slot
    r * n_shards + s.

    Why: RayBatch.from_arrays front-packs live rays, so contiguous
    block-sharding piles every live ray (and every Fresnel-split child)
    onto the first shards while the dead-slot headroom sits idle on the
    tail shards — per-shard compaction then culls real power that the
    single-device trace keeps (measured ~0.6% under the engine-documented
    4x capacity-headroom pattern). Ray order is semantically free, so the
    interleave is exact; `deinterleave_rays` is the inverse.
    """
    if n_shards <= 1:
        return rays
    C = rays.capacity
    if C % n_shards:
        raise ValueError(
            f"capacity {C} not divisible by {n_shards} shards — pad first "
            "(RayBatch.padded_to)")
    S = C // n_shards
    j = jnp.arange(C)
    idx = (j % S) * n_shards + j // S
    return jax.tree_util.tree_map(lambda x: x[idx], rays)


def deinterleave_rays(rays: RayBatch, n_shards: int) -> RayBatch:
    """Inverse of `interleave_rays`: restore original slot order (applied
    to rays_out on the way back so TraceResult slot order is stable)."""
    if n_shards <= 1:
        return rays
    C = rays.capacity
    S = C // n_shards
    i = jnp.arange(C)
    inv = (i % n_shards) * S + i // n_shards
    return jax.tree_util.tree_map(lambda x: x[inv], rays)


def shard_rays(rays: RayBatch, mesh: Mesh, interleave: bool = True) -> RayBatch:
    """Place a RayBatch sharded along capacity over the mesh's ray axis,
    round-robin-interleaving slots across the shards first (see
    `interleave_rays`; pass interleave=False for raw block placement)."""
    if interleave:
        rays = interleave_rays(rays, mesh.devices.size)
    sh = NamedSharding(mesh, P(RAY_AXIS))
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), rays)


@functools.partial(
    jax.jit, static_argnames=("cfg", "iterations", "mesh", "n_detectors")
)
def trace_multichip(scene: Scene, rays: RayBatch, cfg: TraceConfig,
                    iterations: int, mesh: Mesh, n_detectors: int = 8,
                    key=None):
    """Fixed-depth multi-bounce trace, SPMD over the ray axis.

    Returns (rays_out sharded, DetectorState replicated/global,
    Ledger replicated/global). Per-shard compaction keeps each chip's
    capacity fixed; detector bins and the ledger are `psum`ed over ICI at
    the end (BASELINE.json north_star: "psum of detector bins over ICI").

    `n_detectors` sizes the per-detector accumulator — it must be >= the
    number of measure surfaces in the scene (the engine passes
    len(detector_names)). `key` is required iff cfg.needs_rng (roulette
    and/or Lambertian scattering): each shard folds its axis index in,
    so draws are independent across chips and deterministic for a fixed
    mesh.
    """
    if cfg.needs_rng and key is None:
        raise ValueError(
            "cfg.needs_rng (roulette / diffuse) requires a PRNG key "
            "(pass key=jax.random.key(seed) to trace_multichip)")

    def local(scene, rays, key):
        led = Ledger.start(jnp.sum(jnp.where(rays.alive, rays.power, 0.0)))
        det = DetectorState.zeros(
            cfg.hist_azimuth_bins, cfg.hist_polar_bins, n_detectors,
            cfg.image_bins, coherent=cfg.coherent,
            # scene replicated -> triangle ids are global; per-shard
            # partial flux maps psum exactly like the histogram
            n_tris=(scene.v0.shape[0] if cfg.flux_map else 0),
            time_bins=cfg.time_bins,
        )
        if cfg.needs_rng:
            shard_key = jax.random.fold_in(
                key, jax.lax.axis_index(RAY_AXIS))

        def body(i, st):
            rays, det, led = st
            k = (jax.random.fold_in(shard_key, i)
                 if cfg.needs_rng else None)
            rays, det, led, _ = trace_step(scene, rays, det, led, cfg, key=k)
            return rays, det, led

        rays, det, led = jax.lax.fori_loop(0, iterations, body, (rays, det, led))
        det = DetectorState(*(jax.lax.psum(x, RAY_AXIS) for x in det))
        led = Ledger(*(jax.lax.psum(x, RAY_AXIS) for x in led))
        return rays, det, led

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(RAY_AXIS), P()),
        out_specs=(P(RAY_AXIS), P(), P()),
        check_vma=False,
    )(scene, rays, key)
