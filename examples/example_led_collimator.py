"""LED collimator illumination study (AreaSource extension).

A Lambertian square 'LED die' (AreaSource) sits at the focal point of an
ASPHERIC condenser (hyperbolic surface, k = -n^2 — stigmatic, which is
why real LED collimators are aspheric: a spherical singlet at this
aperture, f/0.6, is aberration-dominated and gains only ~3x). The die radiates into the whole forward
hemisphere, so whole-field RMS divergence is the wrong figure of merit —
what a condenser buys is ON-AXIS intensity: the power fraction within a
narrow forward cone. Anchors: the bare die's 10-degree fraction equals
the Lambertian closed form sin^2(10 deg) = 0.030; the condenser multiplies
it several-fold; power conserved in both runs.

    JAX_PLATFORMS=cpu python examples/example_led_collimator.py
"""

import os

import numpy as np

from lightpycl_tpu import AreaSource, optical_elements
from lightpycl_tpu.analysis import beam_statistics
from lightpycl_tpu.tracer.engine import Tracer
from lightpycl_tpu.utils import setup_logging

setup_logging()

RAY_COUNT = int(os.environ.get("RAY_COUNT", 50_000))
n_glass = 1.52
R = 0.3                       # condenser curvature radius (fast, f/0.6)
f = R / (n_glass - 1.0)       # thin-lens focal length ~ 1.154

oe = optical_elements(n_segments=64, n_radial=24)
thick = 0.3
z_focus = thick + R / (n_glass - 1.0)   # hyperbolic singlet focal point
# stigmatic collimator by reversibility: the hyperbolic plano-convex
# focuses a collimated +z beam at z_focus, so a die AT z_focus emitting
# -z exits collimated along -z (flat side away from the die)
# aperture is a DIAMETER; radius 0.5 at ~0.84 rim distance subtends 31
# deg from the die -> captures sin^2(31 deg) ~ 26% of the Lambertian
# emission (every captured ray exits collimated: the surface is exactly
# stigmatic, so the capture cone is the only knob)
lens = oe.aspheric_lens(None, -R, aperture=1.0, thickness=thick,
                        ior=n_glass, k2=-n_glass * n_glass)
die = AreaSource(center=(0, 0, z_focus), direction=(0, 0, -1),
                 width=(0.05, 0.05), power=1.0, ray_count=RAY_COUNT,
                 seed=11)
dome = oe.sphere(radius=12.0, material="measure", name="farfield")

CONE_DEG = 10.0


def axial_fraction(res):
    """Measured power fraction within CONE_DEG of the -z beam axis."""
    sel = res.measured_power > 0
    dz = -res.measured_dir[sel][:, 2]
    pw = res.measured_power[sel]
    return pw[dz > np.cos(np.radians(CONE_DEG))].sum() / pw.sum()


frac = {}
for label, els in [("bare die", [dome]), ("with condenser", [lens, dome])]:
    res = Tracer().trace(die, els, trace_iterations=6, capacity=4 * RAY_COUNT)
    frac[label] = axial_fraction(res)
    print(f"{label:>15}: detected {res.detector_power('farfield'):.4f}, "
          f"within {CONE_DEG:.0f} deg: {frac[label]:.4f}, "
          f"conservation err {res.power_conservation_error():.1e}")

lambertian = np.sin(np.radians(CONE_DEG)) ** 2
print(f"bare-die theory (Lambertian): sin^2({CONE_DEG:.0f} deg) = "
      f"{lambertian:.4f}")
gain = frac["with condenser"] / frac["bare die"]
print(f"on-axis intensity gain from the condenser: {gain:.1f}x")
assert abs(frac["bare die"] - lambertian) < 0.01
assert gain > 5.0

# --- export the collimated luminaire as an IES LM-63 photometric file ----
# (io/ies.py): the far-field web of the LAST trace (with condenser), axis
# along the -z beam; import it back as a light source to check the flux.
import tempfile

from lightpycl_tpu.io.ies import ies_source, load_ies, save_ies

ies_path = tempfile.mktemp(suffix=".ies")
lm = save_ies(ies_path, res.measured_dir, res.measured_power,
              axis=(0, 0, -1), n_vertical=19,
              keywords={"LUMINAIRE": "LED die + stigmatic condenser"})
data = load_ies(ies_path)
src2 = ies_source(data, direction=(0, 0, -1), ray_count=1000)
print(f"IES export: {lm:.1f} lm (web integral {data.total_lumens:.1f}; "
      f"re-imported source power {src2.power:.1f})")
assert abs(data.total_lumens - lm) < 1e-6 * max(lm, 1.0)
