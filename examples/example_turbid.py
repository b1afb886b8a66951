"""Turbid-medium (volume scattering) study: a laser transmissometer.

A collimated beam crosses a fog cell — a refractive slab whose BULK
scatters with coefficient mu_s and Henyey-Greenstein anisotropy g
(GeoObject(scattering=mu_s, scatter_g=g); extension over the reference,
which is surface-optics only — SURVEY.md §1). Free paths are drawn
~ Exp(mu_s); each scatter redraws the direction from the HG phase
function, the workhorse model for fog, milk glass, and tissue optics.

Anchors:
  * the BALLISTIC (unscattered, on-axis) power obeys Beer-Lambert
    exactly: T_ball = e^{-mu_s L}, independent of g — scattering
    extinguishes the coherent beam even though the power survives;
  * cloud-like forward scattering (g = 0.9) delivers far more TOTAL
    power to the detector plane than isotropic fog (g = 0) at the same
    optical depth — why headlights still glow through fog;
  * exact power conservation through arbitrary scatter chains.

    JAX_PLATFORMS=cpu python examples/example_turbid.py
"""

import os

import numpy as np

from lightpycl_tpu import optical_elements
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu.tracer.engine import Tracer
from lightpycl_tpu.utils import setup_logging

setup_logging()

RAY_COUNT = int(os.environ.get("RAY_COUNT", 40_000))
L_CELL = 2.0          # fog-cell thickness
TAU = 2.0             # optical depth mu_s * L
MU_S = TAU / L_CELL

oe = optical_elements()
src = CollimatedSource(center=(0, 0, 0), direction=(0, 0, 1),
                       diameter=0.4, power=1.0, ray_count=RAY_COUNT,
                       seed=3)


def build(g):
    # index-matched cell (n = 1): no Fresnel losses, so every deviation
    # from Beer-Lambert is pure scattering physics
    cell = oe.cube((6.0, 6.0, L_CELL), center=(0, 0, 1.0 + L_CELL / 2),
                   material="refractive", ior=1.0,
                   scattering=MU_S, scatter_g=g)
    screen = oe.rectangle(width=30.0, depth=30.0, center=(0, 0, 10.0),
                          material="measure", name="screen")
    world = oe.sphere(radius=40.0, material="measure", name="world")
    return [cell, screen, world]


def ballistic_power(res):
    """Power reaching the screen undeviated: still +z within the
    original beam footprint."""
    sel = ((res.measured_det == 0) & (res.measured_dir[:, 2] > 0.99999)
           & (np.linalg.norm(res.measured_pos[:, :2], axis=1) < 0.201))
    return res.measured_power[sel].sum()


print(f"fog cell: mu_s = {MU_S:.2f}/len, L = {L_CELL:.1f} "
      f"(optical depth tau = {TAU:.1f})")
t_ball_theory = np.exp(-TAU)
total = {}
for g in (0.0, 0.9):
    res = Tracer().trace(src, build(g), trace_iterations=40,
                         capacity=4 * RAY_COUNT)
    err = res.power_conservation_error()
    t_ball = ballistic_power(res)
    total[g] = res.detector_power("screen")
    print(f"  g = {g:3.1f}: ballistic T = {t_ball:.4f} "
          f"(Beer-Lambert e^-tau = {t_ball_theory:.4f}), "
          f"total on screen = {total[g]:.4f}, conservation err {err:.1e}")
    assert err < 1e-4
    assert abs(t_ball - t_ball_theory) < 0.05 * t_ball_theory + 2e-3

print(f"forward-scattering gain (g=0.9 vs g=0 total flux): "
      f"{total[0.9] / total[0.0]:.2f}x — forward-peaked fog keeps the "
      "light in the beam")
assert total[0.9] > total[0.0] + 0.05
