"""Chromatic dispersion demo (extension over the reference): a white-light
beam through an SF10 prism separates into a spectrum on the detector dome.

The material model is the extended Cauchy n(wl) = A + B/wl^2 + C/wl^4
fitted to the REAL Schott Sellmeier curve of N-SF10
(`lightpycl_tpu.materials.glass_from_sellmeier`); dispersion_b/_c = 0
reproduces the reference's constant-IOR physics exactly.
"""

import os

import numpy as np

import lightpycl_tpu as L
from lightpycl_tpu.materials import glass_from_sellmeier, sellmeier_index
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu.tracer.engine import Tracer
from lightpycl_tpu.utils import setup_logging

setup_logging()

RAY_COUNT = int(os.environ.get("RAY_COUNT", 20_000))

fit = glass_from_sellmeier("N-SF10", band=(0.40, 0.70))
a, b, c = fit["ior"], fit["dispersion_b"], fit["dispersion_c"]
oe = L.optical_elements(n_segments=48, n_radial=16)
prism = oe.prism(width=1.04, height=0.3, length=1.0, **fit)
dome = oe.sphere(10.0, material="measure", name="dome")

# flat white spectrum, 400-700 nm in 16 lines
wls = np.linspace(0.40, 0.70, 16)
src = CollimatedSource(center=(0.3, -0.5, 0), direction=(0, 1, 0),
                       diameter=0.04, ray_count=RAY_COUNT, power=1.0,
                       wavelength=(wls, np.ones_like(wls)))

res = Tracer().trace(src, [prism, dome], trace_iterations=6,
                     capacity=4 * RAY_COUNT)
print(f"ledger: {res.ledger}")

# angular position of each spectral line's transmitted bundle
print(" wl [um]   n(wl)    deviation [deg]")
for wl in wls:
    sel = np.isclose(res.measured_wavelength, wl, atol=1e-4)
    pw = res.measured_power[sel]
    if pw.sum() <= 0:
        continue
    # dominant (transmitted) bundle: rays within the brightest direction
    dirs = res.measured_dir[sel]
    top = dirs[pw.argmax()]
    bundle = dirs @ top > 0.999
    mean = (dirs[bundle] * pw[bundle, None]).sum(0)
    mean /= np.linalg.norm(mean)
    dev = np.degrees(np.arccos(np.clip(mean @ [0, 1, 0], -1, 1)))
    n_model = a + b / wl**2 + c / wl**4
    n_exact = sellmeier_index(wl, "N-SF10")
    print(f"  {wl:.3f}   {n_model:.4f}   {dev:7.3f}"
          f"   (Sellmeier {n_exact:.4f})")
print("shorter wavelengths deviate more: a spectrum.")
