"""Order-of-magnitude scale datapoint: >= 1M triangles.

The streaming design (the triangle soup streamed tile by tile through the
intersect kernel) claims scale beyond the 137k-triangle config-4 mesh.
This benchmark runs the intersect on a 1,048,576-triangle sphere
(1024 x 512 tessellation):

  * brute tests/s (chained-rep methodology, as bench.py)
  * streamed w4 HBM footprint
  * a small full trace for the conservation ledger at this scale
  * cull-on effective tests/s for a coherent bundle into the same mesh

Prints one JSON line (full size on a GPU, a small smoke size elsewhere).
"""

import json
import os
import sys
import time


def main():
    from lightpycl_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp
    import numpy as np

    import lightpycl_tpu as L
    from lightpycl_tpu.sources import CollimatedSource
    from lightpycl_tpu.tracer.config import TraceConfig
    from lightpycl_tpu.tracer.engine import Tracer
    from lightpycl_tpu.tracer.step import intersect

    on_gpu = jax.default_backend() == "gpu"
    if on_gpu:
        seg, rad = 1024, 512          # 2 * 1024 * 512 = 1,048,576 tris
        n_rays = int(os.environ.get("BENCH_RAYS", 1 << 17))
        reps = 3
    else:
        seg, rad = 64, 32
        n_rays = 1 << 10
        reps = 2

    t_mesh0 = time.perf_counter()
    oe = L.optical_elements(n_segments=seg, n_radial=rad)
    ball = oe.sphere(radius=5.0, material="measure", name="shell")
    scene, _ = L.build_scene([ball])
    mesh_s = time.perf_counter() - t_mesh0
    n_tris = ball.num_triangles
    hbm_mb = scene.num_triangles_padded * 12 * 4 / (1 << 20)  # transforms

    rng = np.random.default_rng(0)
    o = jnp.asarray(rng.uniform(-1, 1, (n_rays, 3)), jnp.float32)
    d = rng.normal(size=(n_rays, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True),
                    jnp.float32)
    cfg = TraceConfig()

    @jax.jit
    def bench(o_in, d_in):
        def body(c, _):
            t, i = intersect(scene, o_in + c, d_in, cfg)
            chk = jnp.clip(jnp.sum(jnp.where(jnp.isfinite(t), t, 0.0)),
                           0.0, 1.0)
            return chk * 1e-30, jnp.sum(i)
        c, chks = jax.lax.scan(body, jnp.float32(0.0), None, length=reps)
        return c, chks

    jax.block_until_ready(bench(o, d))
    o2 = jax.block_until_ready(o + jnp.float32(1e-7))
    t0 = time.perf_counter()
    jax.block_until_ready(bench(o2, d))
    dt = (time.perf_counter() - t0) / reps
    tests_per_s = n_rays * n_tris / dt

    # conservation at scale: isotropic point source inside the megashell
    from lightpycl_tpu.sources import light_source

    ls = light_source(center=(0, 0, 0), direction=(0, 0, 1), power=1.0,
                      ray_count=min(n_rays, 1 << 16), seed=1,
                      polar_max=np.pi)
    tr = Tracer()
    res = tr.trace(ls, [ball], trace_iterations=2, mode="device")
    cons_err = res.power_conservation_error()
    measured = res.ledger["measured"]

    # coherent bundle + cull: a thin collimated beam from outside sees a
    # tiny patch of the megashell — the streaming mask should skip nearly
    # every tile
    src_c = CollimatedSource(center=(0, 0, 10.0), direction=(0, 0, -1),
                             diameter=0.5, ray_count=n_rays, power=1.0,
                             seed=2)
    walls = {}
    for cull in (False, True):
        tr_c = Tracer()
        ws = []
        for i in range(3 if on_gpu else 2):
            r = tr_c.trace(src_c, [ball], trace_iterations=2,
                           mode="device", cull=cull)
            if i > 0:
                ws.append(r.wall_time)
        walls[cull] = min(ws)

    out = {
        "metric": "million_tri_intersect",
        "n_triangles": n_tris,
        "n_rays": n_rays,
        "tests_per_s": tests_per_s,
        "w4_hbm_mb": hbm_mb,
        "mesh_build_s": mesh_s,
        "conservation_error": cons_err,
        "measured_power": measured,
        "trace_wall_brute_s": walls[False],
        "trace_wall_cull_s": walls[True],
        "cull_speedup_thin_beam": walls[False] / walls[True],
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
