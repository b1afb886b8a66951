"""Michelson interferometer bench (beamsplitter extension).

A 50/50 beamsplitter at 45 degrees, perfect mirrors in both arms, and a
measurement panel on the output port: ray optics delivers exactly
2 R T = 0.5 of the source power there (0.25 via each arm); the other half
returns toward the source and escapes.

    JAX_PLATFORMS=cpu python examples/example_michelson.py
"""

import os

import numpy as np

from lightpycl_tpu import optical_elements
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu.tracer.engine import Tracer
from lightpycl_tpu.utils import setup_logging

setup_logging()
RAY_COUNT = int(os.environ.get("RAY_COUNT", 20_000))
R = float(os.environ.get("SPLIT_R", 0.5))

oe = optical_elements(n_segments=16, n_radial=6)
els = [
    oe.rectangle(2.0, 2.0, material="beamsplitter",
                 reflectivity=R).rotate((0, 1, 0), np.pi / 4),
    oe.rectangle(2.0, 2.0, material="mirror").rotate(
        (0, 1, 0), np.pi / 2).translate((-1.5, 0, 0)),
    oe.rectangle(2.0, 2.0, material="mirror").rotate(
        (0, 1, 0), np.pi).translate((0, 0, 1.5)),
    oe.rectangle(2.0, 2.0, material="measure", name="output").rotate(
        (0, 1, 0), -np.pi / 2).translate((1.5, 0, 0)),
]
src = CollimatedSource(center=(0, 0, -2.0), direction=(0, 0, 1),
                       diameter=0.5, power=1.0, ray_count=RAY_COUNT, seed=1)

res = Tracer().trace(src, els, trace_iterations=6, capacity=8 * RAY_COUNT)
print(f"output port power: {res.detector_power('output'):.6f} "
      f"(theory 2RT = {2 * R * (1 - R):.6f})")
print(f"returned to source (escaped): {res.ledger['escaped']:.6f}")
print(f"conservation error: {res.power_conservation_error():.2e}")

# --- coherent fringes (no reference equivalent): offset one arm mirror and
# watch the output intensity follow the two-beam law I/I0 = cos^2(2 pi d/wl)
from lightpycl_tpu.tracer.rays import RayBatch

WL = 0.5  # wavelength in SCENE units (only OPL/wl enters the phase)
o, dvec, p = src.sample()


def fringe_intensity(arm_d):
    bench = [els[0],
             els[1].copy().translate((-arm_d, 0, 0)),
             els[2], els[3]]
    r = Tracer().trace(
        None, bench, trace_iterations=6,
        rays=RayBatch.from_arrays(o, dvec, p, capacity=8 * RAY_COUNT,
                                  wavelengths=WL),
        coherent=True, image_bins=32, image_center=(1.5, 0.0, 0.0),
        image_normal=(1.0, 0.0, 0.0), image_halfwidth=0.6)
    return r.image_coherent.sum()


i0 = fringe_intensity(0.0)
print("\narm offset  ->  coherent output (two-beam law)")
for d in (0.0, WL / 8, WL / 4, 3 * WL / 8, WL / 2):
    ratio = fringe_intensity(d) / i0
    theory = (1 + np.cos(4 * np.pi * d / WL)) / 2
    print(f"  {d / WL:4.2f} wl: I/I0 = {ratio:.4f}  (theory {theory:.4f})")

# --- WHITE-LIGHT fringes: a spectral coherent trace keeps one field plane
# per wavelength (different wavelengths are mutually incoherent); the
# fringe contrast washes out once the arm offset exceeds the coherence
# length lc ~ wl^2 / dwl — watch the envelope decay
wls = np.linspace(0.45, 0.60, 6)


def white_light(arm_d):
    bench = [els[0], els[1].copy().translate((-arm_d, 0, 0)),
             els[2], els[3]]
    r = Tracer().trace_spectral(
        None, wls, elements=bench, trace_iterations=6,
        rays=RayBatch.from_arrays(o, dvec, p, capacity=8 * RAY_COUNT),
        coherent=True, image_bins=32, image_center=(1.5, 0.0, 0.0),
        image_normal=(1.0, 0.0, 0.0), image_halfwidth=0.6)
    return r.image_coherent.sum()


w0 = white_light(0.0)
print("\nwhite-light (0.45-0.60 um) fringe envelope:")
for d in (0.0, 0.125, 0.25, 0.5, 1.0, 2.0, 4.0):
    print(f"  arm offset {d:5.3f}: I/I0 = {white_light(d) / w0:.4f}")
