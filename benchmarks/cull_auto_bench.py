"""Cull on/off A/B across bundle-coherence regimes.

The conservative block x tile cull is bit-identical; auto (cull=None)
turns it on for coherent bundles. This measures both sides: the gain on
coherent scenes and what cull=True costs when the mask can't skip
anything (isotropic sources). Three regimes, each min-of-N device-mode
traces:

  bowl       collimated bundle into the parabolic bowl (most culled)
  stack      collimated bundle through the splitting lens stack + dome
  isotropic  point source inside a measure sphere (nothing cullable)

Prints one JSON line per (scene, cull) cell.
"""

import json
import os
import sys
import time


def main():
    from lightpycl_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import numpy as np

    import lightpycl_tpu as L
    from lightpycl_tpu.sources import CollimatedSource, light_source
    from lightpycl_tpu.tracer.engine import Tracer

    on_gpu = jax.default_backend() == "gpu"
    n_rays = int(os.environ.get("BENCH_RAYS",
                                1 << 19 if on_gpu else 1 << 12))
    n_meas = int(os.environ.get("N_MEAS", 5 if on_gpu else 2))
    seg = 256 if on_gpu else 32

    oe = L.optical_elements(n_segments=seg, n_radial=seg // 2)
    oe_s = L.optical_elements(n_segments=128 if on_gpu else 24,
                              n_radial=32 if on_gpu else 8)

    def bowl():
        els = [oe.parabolic_mirror(focus=1.0, diameter=4.0,
                                   reflectivity=0.95),
               oe_s.hemisphere(radius=100.0, name="dome")]
        src = CollimatedSource(center=(0, 0, 3.0), direction=(0, 0, -1),
                               diameter=3.5, ray_count=n_rays, power=1.0,
                               seed=3)
        return els, src, 8

    def stack():
        els = [oe_s.spherical_lens(1.0, -1.0, 0.8, 0.2, ior=1.5,
                                   center=(0, 0, 1.0)),
               oe_s.spherical_lens(1.5, -1.5, 0.8, 0.2, ior=1.7,
                                   center=(0, 0, 1.6)),
               oe.hemisphere(radius=30.0, name="dome")]
        src = CollimatedSource(center=(0, 0, 0), direction=(0, 0, 1),
                               diameter=0.7, ray_count=n_rays // 2,
                               power=1.0, seed=4)
        return els, src, 6

    def isotropic():
        els = [oe.sphere(radius=5.0, material="measure", name="shell")]
        src = light_source(center=(0, 0, 0), direction=(0, 0, 1),
                           power=1.0, ray_count=n_rays, seed=5,
                           polar_max=np.pi)
        return els, src, 4

    for name, build in (("bowl", bowl), ("stack", stack),
                        ("isotropic", isotropic)):
        els, src, iters = build()
        for cull in (False, True):
            tr = Tracer()
            samples = []
            measured = None
            for i in range(n_meas + 1):
                res = tr.trace(src, els, trace_iterations=iters,
                               mode="device", cull=cull,
                               capacity=(src.ray_count * 4
                                         if name == "stack" else None))
                if i > 0:
                    samples.append(res.wall_time)
                measured = res.ledger["measured"]
            print(json.dumps({
                "scene": name, "cull": cull,
                "wall_min": min(samples), "wall_med":
                    sorted(samples)[len(samples) // 2],
                "samples": samples,
                "measured": measured,
                "n_rays": src.ray_count,
                "n_tris": sum(e.num_triangles for e in els),
                "iters": iters,
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
