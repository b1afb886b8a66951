"""Benchmark: wavelength-parallel trace vs per-wavelength scalar traces.

Scene: coated (HL)^3 high-reflector window + two detector discs + shell
(the spectral example's geometry, scaled up). Measures, on the real chip:
  * one spectral trace carrying W wavelengths (trace_spectral), and
  * one scalar trace at a single wavelength (same rays) -> x W projection.
Prints one JSON record.

    python benchmarks/spectral_bench.py          # GPU
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

    from lightpycl_tpu import optical_elements, spectral
    from lightpycl_tpu.sources import CollimatedSource
    from lightpycl_tpu.tracer.config import TraceConfig
    from lightpycl_tpu.tracer.engine import Tracer
    from lightpycl_tpu.tracer.rays import RayBatch

    RAYS = int(os.environ.get("RAY_COUNT", 1 << 19))
    W = int(os.environ.get("N_WL", 32))
    ITERS = 10
    N_HI, N_LO, N_SUB = 2.35, 1.46, 1.52
    WL0 = 0.55
    stack = [(N_HI, WL0 / (4 * N_HI)), (N_LO, WL0 / (4 * N_LO))] * 3

    oe = optical_elements(n_segments=128, n_radial=48)
    els = [
        oe.cube(size=(1.2, 1.2, 0.3), material="refractive", ior=N_SUB,
                coating=stack, name="hr"),
        oe.disc(radius=2.0, center=(0, 0, 2.0), material="measure", name="T"),
        oe.disc(radius=2.0, center=(0, 0, -2.0), material="measure",
                name="R"),
        oe.sphere(radius=8.0, material="terminator"),
    ]
    n_tris = sum(e.num_triangles for e in els)
    src = CollimatedSource(center=(0, 0, -1.0), direction=(0, 0, 1),
                           diameter=0.6, ray_count=RAYS, power=1.0, seed=7)
    o, d, p = src.sample()
    wls = np.linspace(0.40, 0.75, W)

    def run_spectral():
        rays = RayBatch.from_arrays(o, d, p, capacity=2 * RAYS)
        t0 = time.perf_counter()
        per_det, led, names, sr, _ = spectral.trace_spectral(
            els, rays, wls, iterations=ITERS)
        jax.block_until_ready(per_det)
        return time.perf_counter() - t0, np.asarray(per_det), names

    def run_scalar():
        rays = RayBatch.from_arrays(o, d, p, capacity=2 * RAYS,
                                    wavelengths=WL0)
        res = Tracer().trace(src, els, trace_iterations=ITERS, rays=rays,
                             mode="device", dissipation_target=1.0)
        return res.wall_time

    # warm up compiles, then measure second runs
    run_spectral()
    t_spec, per_det, names = run_spectral()
    run_scalar()
    t_scal = run_scalar()

    # physical sanity before recording timings: the HR stopband peak must
    # sit at the design wavelength
    peak = int(per_det[names.index("R")].argmax())
    assert abs(wls[peak] - WL0) < 0.03, (wls[peak], WL0)
    rec = {
        "bench": "spectral_vs_scalar",
        "rays": RAYS, "triangles": n_tris, "wavelengths": W,
        "iterations": ITERS,
        "t_spectral_s": t_spec, "t_scalar_one_wl_s": t_scal,
        "scalar_projected_s": W * t_scal,
        "speedup_vs_scalar_spectrum": W * t_scal / t_spec,
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
    }
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
