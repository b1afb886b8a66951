"""Veiling glare from mirror micro-roughness.

A collimated beam hits a parabolic telescope mirror and converges on a
small focal-plane detector. Surface micro-roughness
(GeoObject(roughness=sigma_rms)) splits every reflection by the
Rayleigh-Rice total integrated scatter TIS = 1 - e^{-(4 pi sigma/lambda)^2}:
the specular share still focuses; the scattered share becomes a wide halo
(roughness_lobe = 0 here, a heavily hazed surface) that misses the
small detector — the classic veiling-glare budget that drives
"super-polished" (sigma < lambda/200) optics for high-contrast imaging.

Anchors: the focal-core power is exactly R x E[1 - TIS(theta_i(r))]
averaged over the beam footprint (TIS carries cos(theta_i), and a fast
parabola is hit obliquely toward the rim — the split itself is
deterministic, so the match is sampling-exact); sigma = lambda/50
already costs ~6% contrast; power conserved in every run.

    JAX_PLATFORMS=cpu python examples/example_rough_mirror.py
"""

import os

import numpy as np

from lightpycl_tpu import optical_elements
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu.tracer.engine import Tracer
from lightpycl_tpu.utils import setup_logging

setup_logging()

RAY_COUNT = int(os.environ.get("RAY_COUNT", 20_000))
WL = 0.5876   # d-line [um]
FOCUS = 1.0
R_MIRROR = 0.98

oe = optical_elements(n_segments=96, n_radial=24)
beam = CollimatedSource(center=(0, 0, 3.0), direction=(0, 0, -1),
                        diameter=1.6, power=1.0, ray_count=RAY_COUNT)


def build(sigma):
    mirror = oe.parabolic_mirror(focus=FOCUS, diameter=2.0,
                                 reflectivity=R_MIRROR,
                                 roughness=sigma, roughness_lobe=0.0)
    core = oe.disc(radius=0.05, center=(0, 0, FOCUS), material="measure",
                   name="focal_core")
    world = oe.sphere(radius=20.0, material="measure", name="world")
    return [mirror, core, world]


print(f"parabolic mirror f = {FOCUS}, R = {R_MIRROR}, lambda = "
      f"{WL * 1e3:.0f} nm — focal-core power vs RMS roughness:")
cores = []
for label, sigma in [("polished  (sigma = 0)", 0.0),
                     ("lambda/100", WL / 100.0),
                     ("lambda/50", WL / 50.0),
                     ("lambda/20", WL / 20.0)]:
    res = Tracer().trace(beam, build(sigma), trace_iterations=4,
                         capacity=4 * RAY_COUNT)
    err = res.power_conservation_error()
    core = res.detector_power("focal_core")
    halo = res.detector_power("world")
    # aperture-averaged theory: a vertical ray at radius r meets the
    # parabola (slope r / 2f) at cos(theta_i) = 1 / sqrt(1 + (r/2f)^2)
    r = np.linspace(0.0, 0.8, 2001)  # beam radius 0.8
    cos_i = 1.0 / np.sqrt(1.0 + (r / (2.0 * FOCUS)) ** 2)
    tis_r = 1.0 - np.exp(-(4.0 * np.pi * sigma * cos_i / WL) ** 2)
    want = R_MIRROR * float(np.trapezoid((1.0 - tis_r) * r, r)
                            / np.trapezoid(r, r))
    print(f"  {label:>22}: core {core:.4f} (theory {want:.4f}), "
          f"halo {halo:.4f}, conservation err {err:.1e}")
    assert err < 1e-4
    assert abs(core - want) < 2e-3
    cores.append(core)

print("every 2x in roughness quadruples the scattered-light budget "
      "(TIS ~ (4 pi sigma / lambda)^2 when small)")
assert cores[0] > cores[1] > cores[2] > cores[3]
loss1 = cores[0] - cores[1]
loss2 = cores[0] - cores[2]
assert 3.0 < loss2 / max(loss1, 1e-9) < 5.0  # ~4x, small-TIS quadratic
