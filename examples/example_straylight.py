"""Stray-light analysis with Lambertian scattering (extension over the
reference, which has specular surfaces only).

A narrow beam enters an open tube at 30 degrees off axis and strikes the
inner wall; a detector sits at the tube bottom, out of the direct path.
Every photon reaching it is stray light. Three wall finishes:

  * black   (terminator)          — ideal baffle, detector stays dark
  * gray    (Lambertian, a=0.3)   — realistic anodized wall, cosine glare
  * mirror  (specular, R=0.9)     — worst case, the wall relays the beam

The Lambertian prediction is checkable: the first wall strike scatters
albedo * P0 cosine-weighted; the detector subtends its view factor of that
hemisphere, and further wall bounces add geometrically-decaying terms.
"""

import os

import numpy as np

from lightpycl_tpu import optical_elements
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu.tracer.engine import Tracer
from lightpycl_tpu.utils import setup_logging

setup_logging()

RAY_COUNT = int(os.environ.get("RAY_COUNT", 200_000))

R_TUBE, L_TUBE = 0.5, 2.0
oe = optical_elements(n_segments=96, n_radial=32)


def build(wall_material, albedo):
    wall = oe.cylinder(radius=R_TUBE, height=L_TUBE,
                       center=(0, 0, L_TUBE / 2), capped=False,
                       material=wall_material, reflectivity=albedo,
                       name="wall")
    det = oe.disc(radius=R_TUBE, center=(0, 0, 1e-4), material="measure",
                  name="detector")
    shell = oe.sphere(radius=10.0, center=(0, 0, 1.0),
                      material="terminator")
    return [wall, det, shell]


# 30 deg off-axis beam through the open top: first strike on the wall at
# z ~ 0.6, never the detector directly
th = np.radians(30.0)
src = CollimatedSource(center=(-0.3, 0, 2.2), direction=(np.sin(th), 0, -np.cos(th)),
                       diameter=0.2, power=1.0, ray_count=RAY_COUNT, seed=3)

for label, matl, albedo in (("black  wall", "terminator", 0.0),
                            ("gray   wall", "diffuse", 0.3),
                            ("mirror wall", "mirror", 0.9)):
    res = Tracer().trace(src, build(matl, albedo), trace_iterations=8,
                         mode="device", capacity=RAY_COUNT)
    print(f"{label}: stray light at detector = "
          f"{res.detector_power('detector'):.5f} of beam power "
          f"(conservation err {res.power_conservation_error():.1e})")

# --- path provenance (track_paths): WHICH wall-bounce chains deliver the
# stray light? Host-mode trace with signatures, ranked by power.
from lightpycl_tpu import analysis

els = build("diffuse", 0.3)
n_prov = min(RAY_COUNT, 20_000)
src_small = CollimatedSource(center=(-0.3, 0, 2.2),
                             direction=(np.sin(th), 0, -np.cos(th)),
                             diameter=0.2, power=1.0, ray_count=n_prov,
                             seed=3)
res = Tracer().trace(src_small, els, trace_iterations=8, mode="host",
                     capacity=n_prov, track_paths=True)
print("\ntop stray-light paths into the detector (gray wall): how many "
      "wall scatters delivered the glare")
for rec in analysis.ghost_paths(res, elements=els, detector="detector",
                                top=5):
    print(f"  {rec['label']:<40} {rec['power']:.5f} "
          f"({rec['fraction'] * 100:.1f}% of stray total, "
          f"{rec['count']} rays)")
