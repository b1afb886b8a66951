"""Aspheric singlet vs spherical singlet: spot size at best focus.

A plano-convex lens with a hyperbolic exit surface (conic constant
k = -n^2, flat side toward the collimated beam) is stigmatic — the only
residual blur is mesh tessellation. The spherical version of the same lens
shows classic spherical aberration: a larger spot, pulled short of the
paraxial focus. (Extension beyond the reference's spherical-only factory.)

    JAX_PLATFORMS=cpu python examples/example_asphere.py
"""

import os

import numpy as np

from lightpycl_tpu import optical_elements
from lightpycl_tpu.analysis import best_focus, encircled_energy, spot_diagram
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu.tracer.engine import Tracer
from lightpycl_tpu.utils import setup_logging

setup_logging()

RAY_COUNT = int(os.environ.get("RAY_COUNT", 20_000))
n, R, thick = 1.5, 0.5, 0.15
z_theory = thick + R / (n - 1.0)

oe = optical_elements(n_segments=192, n_radial=96)
wall = oe.sphere(radius=10.0, material="measure", name="wall")
src = CollimatedSource(center=(0, 0, -0.5), direction=(0, 0, 1),
                       diameter=0.4, power=1.0, ray_count=RAY_COUNT, seed=4)

for label, k2 in [("spherical", 0.0), ("hyperbolic k=-n^2", -n * n)]:
    lens = oe.aspheric_lens(None, -R, aperture=0.5, thickness=thick,
                            ior=n, k2=k2)
    res = Tracer().trace(src, [lens, wall], trace_iterations=3,
                         capacity=4 * RAY_COUNT)
    fwd = res.measured_dir[:, 2] > 0.5
    pos, dirs, pw = (res.measured_pos[fwd], res.measured_dir[fwd],
                     res.measured_power[fwd])
    z_best, rms = best_focus(pos, dirs, pw, z_range=(z_theory - 0.5,
                                                     z_theory + 0.5))
    spot = spot_diagram(pos, dirs, z_best, pw)
    xyz = np.concatenate(
        [spot["xy"], np.full((len(spot["xy"]), 1), z_best)], axis=1)
    radii, frac = encircled_energy(xyz, pw[np.abs(dirs[:, 2]) > 1e-12],
                                   radii=[2 * rms])
    print(f"{label:18s}: best focus z={z_best:.4f} (theory {z_theory:.4f})  "
          f"RMS spot={rms * 1e3:.3f}e-3  "
          f"EE(2*RMS)={frac[0]:.2f}")
