"""Benchmark harness — prints ONE JSON line with the headline metric.

Headline (BASELINE.md): ray-triangle intersection tests/sec/chip, target
>= 1e10 (vs_baseline = value / 1e10). Co-metrics (rays/sec for a full
multi-bounce trace, detected-power parity vs the float64 oracle) ride along
as extra keys.

Scene: BASELINE configs[3] shape — a large mesh (>=100k triangles) with a
directional source; intersect runs through step.intersect (the Pallas
kernel, ops/intersect_gpu.py). Needs a GPU: on any other platform it
exits without a result.
"""

import json
import os
import sys
import time

import numpy as np


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lightpycl_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py needs a GPU, found {jax.default_backend()}")

    import lightpycl_tpu as L
    from lightpycl_tpu.sources import CollimatedSource, light_source
    from lightpycl_tpu.tracer.config import TraceConfig
    from lightpycl_tpu.tracer.engine import Tracer
    from lightpycl_tpu.tracer.step import intersect

    n_rays = int(os.environ.get("BENCH_RAYS", 1 << 19))
    seg, rad = 256, 256  # sphere: 2*256*256 = 131072 triangles
    reps = int(os.environ.get("BENCH_REPS", 4))

    oe = L.optical_elements(n_segments=seg, n_radial=rad)
    big = oe.sphere(radius=5.0, material="terminator", name="bigmesh")
    scene, _ = L.build_scene([big])
    n_tris = big.num_triangles

    rng = np.random.default_rng(0)
    o = rng.uniform(-1, 1, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o_dev, d_dev = jnp.asarray(o), jnp.asarray(d)

    cfg = TraceConfig()

    # Timing: `reps` intersect calls inside ONE jitted scan, chained
    # through a value-level data dependency (adding <=1e-30 to the
    # origins — below f32 resolution but not provably zero), so the
    # compiler cannot hoist, dedupe, or overlap the repetitions; one
    # device sync at the end.
    @jax.jit
    def bench_loop(o_in, d_in):
        def body(carry, _):
            o2 = o_in + carry
            t, i = intersect(scene, o2, d_in, cfg)
            chk = jnp.clip(jnp.sum(jnp.where(jnp.isfinite(t), t, 0.0)), 0.0, 1.0)
            return chk * 1e-30, jnp.sum(i)
        carry, chks = jax.lax.scan(body, jnp.float32(0.0), None, length=reps)
        return carry, chks

    jax.block_until_ready(bench_loop(o_dev, d_dev))  # compile + warm
    t0 = time.perf_counter()
    out = bench_loop(o_dev, d_dev)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    tests_per_s = n_rays * n_tris / dt

    # ---- co-metric: full multi-bounce trace rays/sec (config-1 scene) -----
    # best of 3 warm traces
    oe2 = L.optical_elements(n_segments=128, n_radial=32)
    els = [oe2.parabolic_mirror(0.5, 2.0, reflectivity=0.98),
           oe2.hemisphere(30.0, name="dome")]
    ls = light_source(center=(0, 0, 0.5), direction=(0, 0, -1),
                      power=1.0, ray_count=n_rays, seed=7)
    tr = Tracer()
    rays_per_s = 0.0
    for i in range(4):  # first = compile+warm, dropped
        res = tr.trace(ls, els, trace_iterations=8, mode="device")
        r = (res.rays_traced / max(res.iterations_run, 1)
             / max(res.wall_time, 1e-12))
        if i > 0:
            rays_per_s = max(rays_per_s, r)

    # ---- co-metric: cull accelerator on the coherent bowl scene ----------
    # effective tests/s counts provably-skipped pairs as done: identical
    # physics, less wall (the auto-enabled path for coherent bundles)
    oe_b = L.optical_elements(n_segments=seg, n_radial=rad // 2)
    bowl = [oe_b.parabolic_mirror(focus=1.0, diameter=4.0,
                                  reflectivity=0.95),
            oe2.hemisphere(radius=100.0, name="dome")]
    src_b = CollimatedSource(center=(0, 0, 3.0), direction=(0, 0, -1),
                             diameter=3.5, ray_count=n_rays, power=1.0,
                             seed=3)
    n_tris_b = sum(e.num_triangles for e in bowl)
    walls = {True: [], False: []}
    for cull in (False, True):
        tr_b = Tracer()
        for i in range(3):
            res_b = tr_b.trace(src_b, bowl, trace_iterations=6,
                               mode="device", cull=cull)
            if i > 0:
                walls[cull].append(res_b.wall_time)
    iters_b = res_b.iterations_run
    tests_eff = n_rays * n_tris_b * iters_b / min(walls[True])
    cull_speedup = min(walls[False]) / min(walls[True])

    # ---- parity co-metric (small, vs float64 oracle) ----------------------
    from lightpycl_tpu.tracer.oracle import trace_oracle

    ls_small = light_source(center=(0, 0, 0.5), direction=(0, 0, -1),
                            power=1.0, ray_count=4096, seed=9)
    org, dr, pw = ls_small.sample()
    res_s = Tracer().trace(ls_small, els, trace_iterations=6,
                           rays=L.RayBatch.from_arrays(org, dr, pw))
    ora = trace_oracle(els, org, dr, pw, trace_iterations=6)
    parity = abs(res_s.ledger["measured"] - ora["measured"]) / max(ora["measured"], 1e-30)

    out = {
        "metric": "ray_triangle_tests_per_sec_per_chip",
        "value": tests_per_s,
        "unit": "tests/s",
        "vs_baseline": tests_per_s / 1e10,
        "rays_per_sec_full_trace": rays_per_s,
        "culled_effective_tests_per_s": tests_eff,
        "cull_speedup_bowl": cull_speedup,
        "detected_power_parity_rel_err": parity,
        "n_rays": n_rays,
        "n_triangles": n_tris,
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "device_count": len(jax.devices()),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    sys.exit(main())
