"""Benchmark: wavelength-BATCHED dispersive trace vs sequential scalars.

Scene: an SF10 prism spectrometer (Cauchy-dispersive glass + detector dome)
— exactly the workload trace_spectral's shared-geometry model rejects
(refraction angles differ per wavelength). Measures, warm, on the chip:
  * one batched trace of W * C wavelength-stamped rays
    (spectral.trace_spectral_dispersive), vs
  * W sequential scalar traces of C rays each (measured once warm, x W).

The intersection work is inherently W-fold either way (unlike the
achromatic shared-geometry path); the batched win is dispatch overhead and
device utilization — at small-to-mid per-wavelength ray counts the W
sequential traces each under-fill the chip while the flattened batch runs
in the kernel's high-occupancy regime. Prints one JSON record
(bench=dispersive_vs_scalar).

    python benchmarks/dispersive_bench.py          # GPU
"""

import json
import os
import time

import numpy as np


def main():
    from lightpycl_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    from lightpycl_tpu import optical_elements, spectral
    from lightpycl_tpu.materials import SF10
    from lightpycl_tpu.sources import CollimatedSource
    from lightpycl_tpu.tracer.engine import Tracer
    from lightpycl_tpu.tracer.rays import RayBatch

    C = int(os.environ.get("RAY_COUNT", 1 << 14))      # rays per wavelength
    W = int(os.environ.get("N_WL", 16))
    ITERS = 6
    HEADROOM = 4

    a, b = SF10
    oe = optical_elements(n_segments=96, n_radial=32)
    prism = oe.prism(width=1.04, height=0.3, length=1.0, ior=a)
    prism.dispersion_b = b
    dome = oe.sphere(10.0, material="measure", name="dome")
    els = [prism, dome]
    n_tris = sum(e.num_triangles for e in els)

    src = CollimatedSource(center=(0.3, -0.5, 0), direction=(0, 1, 0),
                           diameter=0.04, ray_count=C, power=1.0, seed=7)
    o, d, p = src.sample()
    wls = np.linspace(0.38, 0.70, W)

    def run_batched():
        rays = RayBatch.from_arrays(o, d, p, capacity=HEADROOM * C)
        t0 = time.perf_counter()
        per_dw, led, names, _, _, _, _ = spectral.trace_spectral_dispersive(
            els, rays, wls, iterations=ITERS)
        jax.block_until_ready(per_dw)
        return time.perf_counter() - t0, np.asarray(per_dw), names

    def run_scalar(wl):
        rays = RayBatch.from_arrays(o, d, p, capacity=HEADROOM * C,
                                    wavelengths=wl)
        res = Tracer().trace(src, els, trace_iterations=ITERS, rays=rays,
                             mode="device", dissipation_target=1.0)
        return res.wall_time, res.detector_power("dome")

    # warm up compiles, then report the MIN of 3 timed runs
    run_batched()
    runs = [run_batched() for _ in range(3)]
    t_batched, per_dw, names = min(runs, key=lambda r: r[0])
    run_scalar(wls[0])
    t_scal, p_scal = min((run_scalar(wls[0]) for _ in range(3)),
                         key=lambda r: r[0])

    # physical sanity before recording timings: batched column 0 must
    # reproduce the scalar trace at the same wavelength
    p_batched0 = float(per_dw[names.index("dome"), 0]) * W
    assert abs(p_batched0 - p_scal) < 5e-3 * max(p_scal, 1e-9), (
        p_batched0, p_scal)
    rec = {
        "bench": "dispersive_vs_scalar",
        "rays_per_wavelength": C, "triangles": n_tris, "wavelengths": W,
        "iterations": ITERS, "capacity_headroom": HEADROOM,
        "t_batched_s": t_batched, "t_scalar_one_wl_s": t_scal,
        "scalar_projected_s": W * t_scal,
        "speedup_vs_sequential": W * t_scal / t_batched,
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
    }
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
