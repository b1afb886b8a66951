"""Run all five BASELINE.json configs and emit one JSON line each:
throughput + detected power + parity vs the f64 oracle where feasible.

Sizes are modest by default (env-tunable) so the whole sweep finishes in
minutes; bench.py remains the headline single-metric harness.
"""

import json
import os
import sys
import time

import numpy as np


def emit(name, **kw):
    print(json.dumps({"config": name, **kw}), flush=True)


def main():
    from lightpycl_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    import lightpycl_tpu as L
    from lightpycl_tpu.sources import CollimatedSource, light_source
    from lightpycl_tpu.tracer.config import TraceConfig
    from lightpycl_tpu.tracer.engine import Tracer
    from lightpycl_tpu.tracer.oracle import trace_oracle

    scale = float(os.environ.get("BASE_SCALE", 1.0))
    # BASE_ONLY="4" (comma-separated config numbers) reruns a subset —
    # e.g. after touching only the batched/cull path
    only = {s for s in os.environ.get("BASE_ONLY", "").split(",") if s}

    def want(num: str) -> bool:
        return not only or num in only

    # ---- config 1: point source + parabolic mirror + hemisphere ----------
    oe = L.optical_elements(n_segments=128, n_radial=32)
    els = [oe.parabolic_mirror(0.5, 2.0, reflectivity=0.98),
           oe.hemisphere(50.0, name="dome")]
    if want("1"):
        n1 = int(100_000 * scale)
        ls = light_source(center=(0, 0, 0.5), direction=(0, 0, -1),
                          directivity=lambda az, pol: np.cos(pol),
                          power=1.0, ray_count=n1, seed=1)
        tr = Tracer()
        res = tr.trace(ls, els, trace_iterations=8, mode="device")  # compile
        t0 = time.perf_counter()
        res = tr.trace(ls, els, trace_iterations=8, mode="device")
        wall = time.perf_counter() - t0
        o, d, p = ls.sample()
        n_par = min(n1, 4096)
        ora = trace_oracle(els, o[:n_par], d[:n_par],
                           p[:n_par] * (p.sum() / p[:n_par].sum()),
                           trace_iterations=8)
        res_par = Tracer().trace(None, els, trace_iterations=8,
                                 rays=L.RayBatch.from_arrays(
                                     o[:n_par], d[:n_par],
                                     p[:n_par] * (p.sum() / p[:n_par].sum())))
        parity = (abs(res_par.ledger["measured"] - ora["measured"])
                  / ora["measured"])
        emit("1_parabolic_collimator", rays=n1, triangles=tr.num_triangles,
             detected_power=res.ledger["measured"], wall_s=wall,
             rays_per_s=n1 / wall, parity_rel_err=parity)

    # ---- config 2: plano-convex, focal map --------------------------------
    oe2 = L.optical_elements(n_segments=128, n_radial=48)
    if want("2"):
        n2 = int(1_000_000 * scale)
        lens = oe2.plano_convex_lens(r=0.5, aperture=0.6, thickness=0.1,
                                     ior=1.5)
        det = oe2.disc(radius=0.5, center=(0, 0, 1.1), material="measure")
        enc = oe2.sphere(radius=10.0, material="terminator")
        src = CollimatedSource(center=(0, 0, -0.5), direction=(0, 0, 1),
                               diameter=0.4, power=1.0, ray_count=n2, seed=2)
        tr2 = Tracer()
        kw = dict(image_bins=128, image_center=(0, 0, 1.1),
                  image_halfwidth=0.05)
        tr2.trace(src, [lens, det, enc], trace_iterations=6, mode="device",
                  **kw)
        t0 = time.perf_counter()
        res2 = tr2.trace(src, [lens, det, enc], trace_iterations=6,
                         mode="device", **kw)
        wall = time.perf_counter() - t0
        peak = np.unravel_index(res2.image.argmax(), res2.image.shape)
        R0 = ((1.5 - 1) / (1.5 + 1)) ** 2
        emit("2_plano_convex_focal_map", rays=n2, triangles=tr2.num_triangles,
             detected_power=res2.ledger["measured"],
             theory_direct_transmission=(1 - R0) ** 2,
             image_peak_bin=list(map(int, peak)), wall_s=wall,
             rays_per_s=n2 / wall)

    # ---- config 3: two-element stack with splitting ----------------------
    if want("3"):
        n3 = int(200_000 * scale)
        l1 = oe2.biconvex_lens(1.0, 0.8, 0.2, ior=1.5)
        l2 = oe2.biconvex_lens(1.5, 0.8, 0.15, ior=1.7).translate((0, 0, 0.5))
        enc3 = oe2.sphere(radius=6.0, material="measure", name="enclosure")
        src3 = CollimatedSource(center=(0, 0, -0.5), direction=(0, 0, 1),
                                diameter=0.5, power=1.0, ray_count=n3, seed=3)
        tr3 = Tracer()
        tr3.trace(src3, [l1, l2, enc3], trace_iterations=5, mode="device",
                  capacity=4 * n3)
        t0 = time.perf_counter()
        res3 = tr3.trace(src3, [l1, l2, enc3], trace_iterations=5,
                         mode="device", capacity=4 * n3)
        wall = time.perf_counter() - t0
        acc = sum(res3.ledger[k]
                  for k in ("measured", "absorbed", "escaped", "culled"))
        emit("3_lens_stack_splitting", rays=n3, triangles=tr3.num_triangles,
             detected_power=res3.ledger["measured"], accounted=acc,
             wall_s=wall, rays_per_s=n3 / wall)

    # ---- config 4: large mesh, mega-batched -------------------------------
    if want("4"):
        n4 = int(16_000_000 * scale)
        seg = 360
        oe4 = L.optical_elements(n_segments=seg, n_radial=seg // 2)
        bowl = oe4.parabolic_mirror(focus=1.0, diameter=4.0,
                                    reflectivity=0.95)
        dome4 = L.optical_elements(128, 32).hemisphere(radius=100.0,
                                                       name="dome")
        src4 = CollimatedSource(center=(0, 0, 5.0), direction=(0, 0, -1),
                                diameter=3.5, power=1.0, ray_count=4_000_000)
        # Two rows: cull=False is the brute rate; cull=None resolves ON
        # for this collimated bundle, so its tests_per_s is the EFFECTIVE
        # production rate (provably-skipped pairs count as done —
        # identical hits).
        for label, cull in (("4_large_mesh_megabatch", False),
                            ("4_large_mesh_megabatch_autocull", None)):
            tr4 = Tracer(TraceConfig(trace_iterations=4, cull=cull))
            # warm accounting (BASELINE.md): the first batch pays the jit
            # compile — run one batch to compile, record that cost
            # explicitly, then time the full run warm so tests_per_s is
            # the steady state the 100M-ray runs sustain.
            t0 = time.perf_counter()
            tr4.trace_batched(src4, total_rays=4_000_000,
                              batch_size=4_000_000, elements=[bowl, dome4])
            compile_first_batch_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            res4 = tr4.trace_batched(src4, total_rays=n4,
                                     batch_size=4_000_000,
                                     elements=[bowl, dome4])
            wall = time.perf_counter() - t0
            emit(label, rays=n4, triangles=tr4.num_triangles,
                 detected_power=res4.ledger["measured"],
                 conservation_err=abs(res4.ledger["emitted"]
                                      - sum(res4.ledger[k] for k in
                                            ("measured", "absorbed",
                                             "escaped", "culled")))
                 / res4.ledger["emitted"],
                 wall_s=wall, tests_per_s=res4.intersection_tests / wall,
                 cull=cull, warm=True,
                 compile_first_batch_s=compile_first_batch_s)

    # ---- config 5: multichip (real mesh if >1 device, else note) ----------
    if not want("5"):
        return
    n_dev = len(jax.devices())
    if n_dev >= 2:
        from lightpycl_tpu.parallel.sharding import (
            make_ray_mesh, shard_rays, trace_multichip)
        from lightpycl_tpu.tracer.rays import RayBatch

        ls5 = light_source(center=(0, 0, 0.5), direction=(0, 0, -1),
                           power=1.0, ray_count=1 << 17, seed=5)
        o, d, p = ls5.sample()
        scene, _ = L.build_scene(els)
        times = {}
        for nd in [x for x in (1, 2, 4, 8) if x <= n_dev]:
            mesh = make_ray_mesh(nd)
            rays = shard_rays(RayBatch.from_arrays(o, d, p), mesh)
            out = trace_multichip(scene, rays, TraceConfig(), 6, mesh)
            jax.block_until_ready(out)
            rays = shard_rays(RayBatch.from_arrays(o, d, p), mesh)
            t0 = time.perf_counter()
            out = jax.block_until_ready(
                trace_multichip(scene, rays, TraceConfig(), 6, mesh))
            times[nd] = time.perf_counter() - t0
        emit("5_multichip_scaling", devices=n_dev, times_s=times,
             measured=float(out[2].measured))
    else:
        emit("5_multichip_scaling", devices=n_dev,
             note="one device: run on 4 cards (chip_smoke.py --multi) or "
                  "on the virtual CPU mesh (tests/test_sharding.py)")


if __name__ == "__main__":
    sys.exit(main())
