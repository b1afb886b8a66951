"""Freeform null corrector, Schmidt-style: design a Zernike corrector
plate for a fast singlet purely from TRACED wavefronts — no lens
prescription used — the way an optical shop iterates a null test.

Loop: trace the system, fit the measured OPL on the pupil with
analysis.zernike_fit (Noll), subtract the fitted high-order error from
the corrector plate's sag (a thin plate imprints W = (n-1) s, so
delta_sag = -W_j / (n-1)), rebuild with oe.zernike_plate, repeat. The
pupil-distortion of the aberrated beam makes a single shot land only
~60-90% of each term (and cross-couples spherical <-> secondary
spherical), but that is exactly what the iteration absorbs: three
passes cut the high-order wavefront RMS ~15-20x, down to the mesh/fit
noise floor. The corrector and the measurement share one Noll
convention end to end.

Run: RAY_COUNT=4000 python examples/example_schmidt.py
     JAX_PLATFORMS=cpu runs it on the CPU.
"""

import os

import numpy as np

import lightpycl_tpu as L
from lightpycl_tpu.analysis import zernike_fit
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu.tracer.engine import Tracer
from lightpycl_tpu.utils import setup_logging

setup_logging()

RAY_COUNT = int(os.environ.get("RAY_COUNT", 4000))

D, N_GLASS = 0.5, 1.5                  # ~f/2 singlet, flat side first
N_TERMS = 22                           # through secondary spherical
oe = L.optical_elements(n_segments=96, n_radial=48)
lens = oe.plano_convex_lens(r=0.5, aperture=0.6, thickness=0.1,
                            ior=N_GLASS)
# screen close behind the lens: the measured (x, y) IS the pupil
# coordinate up to the converging-beam contraction (held fixed below)
screen = oe.disc(radius=0.3, center=(0, 0, 0.25), material="measure",
                 name="screen")
src = CollimatedSource(center=(0, 0, -1.0), direction=(0, 0, 1),
                       diameter=D, power=1.0, ray_count=RAY_COUNT, seed=4)

_radius = None


def fit_wavefront(elements):
    """Fit the direct bundle's raw OPL on the screen pupil. The direct
    window must pass the converging beam's own defocus OPL spread
    (~sphere sag across the pupil, ~0.02 here) while excluding the
    corrector's internal ghosts at +2 n t_plate = +0.09 — a window the
    same size as the defocus spread razor-clips the pupil rim and
    destabilizes the loop. Piston/tilt/defocus are reference and focus
    choices; Noll j >= 5 is the aberration content."""
    global _radius
    res = Tracer().trace(src, elements, trace_iterations=8,
                         capacity=16 * RAY_COUNT)
    opl, pw = res.measured_opl, res.measured_power
    direct = opl < opl.min() + 0.05
    xy = res.measured_pos[direct][:, :2]
    if _radius is None:                 # pupil disc fixed on the first fit
        _radius = float(np.hypot(xy[:, 0], xy[:, 1]).max())
    fit = zernike_fit(xy, opl[direct], n_terms=N_TERMS,
                      powers=pw[direct], radius=_radius)
    return fit["coeffs"]


c = fit_wavefront([lens, screen])
rms0 = float(np.hypot.reduce(c[4:]))
print(f"bare singlet: high-order wavefront RMS {rms0:.3e} "
      f"(spherical {c[10]:+.2e}, secondary spherical {c[21]:+.2e})")

sag = {j: 0.0 for j in range(5, N_TERMS + 1)}
for it in range(1, 4):
    for j in sag:                       # Newton step on the plate figure
        sag[j] -= float(c[j - 1]) / (N_GLASS - 1.0)
    corrector = oe.zernike_plate(aperture=D, thickness=0.03, coeffs=sag,
                                 ior=N_GLASS, center=(0, 0, -0.4))
    c = fit_wavefront([corrector, lens, screen])
    rms = float(np.hypot.reduce(c[4:]))
    print(f"null iteration {it}: high-order wavefront RMS {rms:.3e}")

print(f"wavefront error cut {rms0 / max(rms, 1e-12):.1f}x by the "
      "traced-and-fitted Zernike null plate")
assert rms < rms0 / 8.0
