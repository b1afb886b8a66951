"""Fresnel lens vs its parent plano-convex singlet.

Collapses a plano-convex lens (R = 2, f ~ 4) into a 16-groove Fresnel
slab 3.3x thinner than the parent's sag, traces a collimated beam through
both, and compares best-focus position, spot size, and delivered power
(the grooved risers are real geometry, so the Fresnel lens loses a bit of
light to stray refraction — exactly like molded Fresnel optics).

Run: RAY_COUNT=4096 python examples/example_fresnel_lens.py
"""

import os

import numpy as np

import lightpycl_tpu as L
from lightpycl_tpu import analysis
from lightpycl_tpu.materials import Material
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu.tracer.config import TraceConfig
from lightpycl_tpu.tracer.engine import Tracer

RAY_COUNT = int(os.environ.get("RAY_COUNT", 4096))
R, APERTURE, N = 2.0, 1.6, 1.5

oe = L.optical_elements(n_segments=48, n_radial=32)


def run(lens, label):
    det = oe.disc(radius=4.0, center=(0, 0, 8.0),
                  material=Material.MEASURE, name="plane").rotate(
        (1, 0, 0), np.pi, pivot=(0, 0, 8.0))
    src = CollimatedSource(center=(0, 0, -1.0), direction=(0, 0, 1),
                           diameter=1.4, ray_count=RAY_COUNT, power=1.0,
                           seed=0)
    tr = Tracer(TraceConfig(trace_iterations=8))
    res = tr.trace(src, elements=[lens, det], mode="host",
                   capacity=4 * RAY_COUNT)
    pos, dirs, pw = res.measured_rays_for("plane")
    z, rms = analysis.best_focus(pos, dirs, pw, z_range=(1.0, 7.0))
    thick = lens.vertices[:, 2].max() - lens.vertices[:, 2].min()
    print(f"{label:14s} thickness={thick:.3f}  best focus z={z:.3f} "
          f"(thin-lens f={R / (N - 1):.1f})  rms spot={rms:.4f}  "
          f"power on plane={pw.sum():.4f}")
    return res


fresnel = oe.fresnel_lens(R, APERTURE, 0.05, n_grooves=16, ior=N)
parent = oe.plano_convex_lens(R, APERTURE, 0.20, ior=N)
run(parent, "plano-convex")
res = run(fresnel, "fresnel")
print("ledger:", {k: round(v, 4) for k, v in res.ledger.items()})
