"""Per-stage wall-time breakdown of one warm trace bounce on the GPU.

Config-4 shape (4M rays x ~137k triangles, the mega-batch steady state):
times four nested pipelines, each as chained reps inside one jitted scan
(as bench.py does):

  A intersect                      (the intersect alone)
  B intersect + shade              (+ branchless material epilogue)
  C intersect + shade + detector   (+ histogram/per-detector scatter-adds)
  D full trace_step                (+ top-k compaction, ledger)

Differences B-A, C-B, D-C attribute the end-to-end vs intersect-only gap
to shade, detector accumulation, or compaction. Prints one JSON line.

    python benchmarks/profile_bounce.py            # GPU
    RAY_COUNT=... REPS=... to resize
"""

import json
import os
import time

import numpy as np


def main():
    from lightpycl_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    import lightpycl_tpu as L
    from lightpycl_tpu.tracer.config import TraceConfig
    from lightpycl_tpu.tracer.rays import DetectorState, Ledger, RayBatch
    from lightpycl_tpu.tracer import step as sm

    on_gpu = jax.default_backend() == "gpu"
    C = int(os.environ.get("RAY_COUNT", 1 << 22 if on_gpu else 1 << 12))
    REPS = int(os.environ.get("REPS", 4 if on_gpu else 2))

    # config-4 scene: 360-segment parabolic bowl + detector dome
    seg = 360 if on_gpu else 48
    oe4 = L.optical_elements(n_segments=seg, n_radial=seg // 2)
    bowl = oe4.parabolic_mirror(focus=1.0, diameter=4.0, reflectivity=0.95)
    dome = L.optical_elements(128 if on_gpu else 24,
                              32 if on_gpu else 8).hemisphere(
        radius=100.0, name="dome")
    els = [bowl, dome]
    scene, det_names = L.build_scene(els)
    n_tris = sum(e.num_triangles for e in els)
    cfg = TraceConfig()

    rng = np.random.default_rng(0)
    o = rng.uniform(-1.5, 1.5, (C, 3)).astype(np.float32)
    o[:, 2] += 3.0
    d = rng.normal(size=(C, 3))
    d[:, 2] -= 1.0  # biased downward so most rays hit the bowl
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    rays0 = RayBatch.from_arrays(o, d, np.full(C, 1.0 / C, np.float32))
    o_dev = jnp.asarray(o)

    def chk_of(*xs):
        s = sum(jnp.sum(jnp.where(jnp.isfinite(x), x, 0.0).astype(jnp.float32))
                for x in xs)
        return jnp.clip(s, 0.0, 1.0) * 1e-30

    def stage_a(o2):
        t, i = sm.intersect(scene, o2, rays0.d, cfg)
        return chk_of(t), jnp.sum(i)

    def stage_b(o2):
        rays = rays0._replace(o=o2)
        t, tri = sm.intersect(scene, rays.o, rays.d, cfg)
        sh = sm.shade(scene, rays, t, tri, cfg)
        return chk_of(sh.child_power), sh.absorbed

    def stage_c(o2):
        rays = rays0._replace(o=o2)
        det = DetectorState.zeros(cfg.hist_azimuth_bins, cfg.hist_polar_bins,
                                  len(det_names), cfg.image_bins)
        t, tri = sm.intersect(scene, rays.o, rays.d, cfg)
        sh = sm.shade(scene, rays, t, tri, cfg)
        det = sm.accumulate_detector(det, sh, rays, cfg)
        return chk_of(sh.child_power, det.per_detector), jnp.sum(det.hist)

    def stage_d(o2):
        rays = rays0._replace(o=o2)
        det = DetectorState.zeros(cfg.hist_azimuth_bins, cfg.hist_polar_bins,
                                  len(det_names), cfg.image_bins)
        led = Ledger.start(1.0)
        new_rays, det, led, _ = sm.trace_step(scene, rays, det, led, cfg)
        return chk_of(new_rays.power), led.measured

    def timed(stage_fn, label):
        @jax.jit
        def loop():
            def body(carry, _):
                ch, out = stage_fn(o_dev + carry)
                return ch, out
            return jax.lax.scan(body, jnp.float32(0.0), None, length=REPS)

        jax.block_until_ready(loop())  # compile + warm
        t0 = time.perf_counter()
        jax.block_until_ready(loop())
        dt = (time.perf_counter() - t0) / REPS
        print(f"{label:>28}: {dt * 1e3:9.2f} ms/bounce  "
              f"({C * n_tris / dt:.3g} tests/s)", flush=True)
        return dt

    # the engine disables splitting for this scene (mirror + measure, no
    # refractive elements -> _tune_splitting sets allow_splitting=False),
    # so the REAL config-4 device path skips the 2C top-k compaction:
    # time that variant too (r5 — the floor the batched run should hit)
    cfg_ns = cfg.replace(allow_splitting=False)

    def stage_d2(o2):
        rays = rays0._replace(o=o2)
        det = DetectorState.zeros(cfg.hist_azimuth_bins, cfg.hist_polar_bins,
                                  len(det_names), cfg.image_bins)
        led = Ledger.start(1.0)
        new_rays, det, led, _ = sm.trace_step(scene, rays, det, led, cfg_ns)
        return chk_of(new_rays.power), led.measured

    t_a = timed(stage_a, "A intersect")
    t_b = timed(stage_b, "B +shade")
    t_c = timed(stage_c, "C +detector")
    t_d = timed(stage_d, "D full step (+compact)")
    t_d2 = timed(stage_d2, "D2 full step (no-split)")

    rec = {
        "bench": "bounce_profile",
        "rays": C, "triangles": n_tris, "reps": REPS,
        "t_intersect_ms": t_a * 1e3,
        "t_shade_ms": (t_b - t_a) * 1e3,
        "t_detector_ms": (t_c - t_b) * 1e3,
        "t_compact_ms": (t_d - t_c) * 1e3,
        "t_full_ms": t_d * 1e3,
        "t_full_nosplit_ms": t_d2 * 1e3,
        "tests_per_s_intersect_only": C * n_tris / t_a,
        "tests_per_s_full_step": C * n_tris / t_d,
        "tests_per_s_full_step_nosplit": C * n_tris / t_d2,
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
    }
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
