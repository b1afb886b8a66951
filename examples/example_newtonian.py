"""Newtonian telescope with aluminum mirrors (metal-mirror extension).

A parabolic aluminum primary collimator... rather: a collimated star beam
hits the parabolic aluminum primary, converges toward focus, and is folded
90 degrees by a flat aluminum diagonal onto the detector. Two physically
real metal effects fall out of the complex-Fresnel mirror model:

  1. throughput: the aluminum telescope detects R_Al(~0) * R_Al(~45 deg)
     ~ 84% of what the SAME telescope with ideal mirrors detects (running
     both cancels the geometric losses — mask obstruction and the tilted
     pickoff's partial cone coverage — exactly);
  2. instrumental polarization: the 45-degree fold's Rs != Rp turns
     UNPOLARIZED starlight partially polarized — degree of polarization
     equals the diattenuation (Rs - Rp)/(Rs + Rp) at 45 degrees, a classic
     systematic in polarimetry.

    JAX_PLATFORMS=cpu python examples/example_newtonian.py
"""

import os

import jax
import jax.numpy as jnp
import numpy as np

from lightpycl_tpu import optical_elements
from lightpycl_tpu.analysis import degree_of_polarization
from lightpycl_tpu.materials import ALUMINUM
from lightpycl_tpu.physics import metal_rs_rp
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu.tracer.engine import Tracer
from lightpycl_tpu.utils import setup_logging

setup_logging()

RAY_COUNT = int(os.environ.get("RAY_COUNT", 20_000))
AL_N, AL_K = ALUMINUM

oe = optical_elements(n_segments=96, n_radial=32)
# parabolic primary, focus 2.0 above the vertex, pointing +z
primary = oe.parabolic_mirror(focus=2.0, diameter=1.6, reflectivity=1.0)
primary.metal_n, primary.metal_k = AL_N, AL_K
# flat aluminum diagonal at 45 deg, 0.9 below focus, folding +x; sized to
# catch the converging annular cone
# radius sized so the 45-deg-projected footprint (r cos45 = 0.31) covers
# the 0.27-radius converging cone while staying inside the 0.34 annulus
# shadow of the entrance mask
diag = oe.disc(radius=0.44, center=(0, 0, 1.1), material="mirror")
diag.metal_n, diag.metal_k = AL_N, AL_K
diag.rotate((0, 1, 0), np.radians(-45.0), pivot=(0, 0, 1.1))
# annular entrance mask: blocks the central bundle so no starlight hits
# the diagonal's back directly — the obstruction fraction becomes EXACT
# ((r_in/r_beam)^2 of the uniform beam), which keeps the throughput
# anchor closed-form
R_BEAM, R_IN = 0.6, 0.34
mask = oe.disc(radius=R_IN, center=(0, 0, 3.0), material="terminator")
f_open = 1.0 - (R_IN / R_BEAM) ** 2
# detector at the folded focus, 0.9 along +x from the fold point —
# outside the entrance beam, so it casts no shadow
det = oe.disc(radius=0.2, center=(0.9, 0, 1.1), material="measure",
              name="eyepiece")
det.rotate((0, 1, 0), np.radians(90.0), pivot=(0.9, 0, 1.1))
shell = oe.sphere(radius=15.0, material="terminator")

src = CollimatedSource(center=(0, 0, 4.0), direction=(0, 0, -1),
                       diameter=2 * R_BEAM, power=1.0, ray_count=RAY_COUNT,
                       seed=5)

def run(metal: bool):
    for el in (primary, diag):
        el.metal_n, el.metal_k = (AL_N, AL_K) if metal else (0.0, 0.0)
    return Tracer().trace(src, [primary, diag, mask, det, shell],
                          trace_iterations=5, polarization=True,
                          capacity=2 * RAY_COUNT)


res_ideal = run(False)
res = run(True)
P_ideal = res_ideal.detector_power("eyepiece")
P_det = res.detector_power("eyepiece")
sel = (res.measured_det == res.detector_names.index("eyepiece")) & (
    res.measured_power > 0)
dop = degree_of_polarization(res.measured_stokes[sel],
                             res.measured_power[sel])

arr = lambda x: jnp.atleast_1d(jnp.asarray(x, jnp.float32))
# jit the analytic helper: one compiled call instead of eager ops
metal_rs_rp = jax.jit(metal_rs_rp)
rs45, rp45 = metal_rs_rp(arr(np.cos(np.radians(45.0))), arr(1.0),
                         arr(AL_N), arr(AL_K))
Rs, Rp = float(jnp.abs(rs45)[0]) ** 2, float(jnp.abs(rp45)[0]) ** 2
R0 = float(jnp.abs(metal_rs_rp(arr(1.0), arr(1.0), arr(AL_N),
                               arr(AL_K))[0])[0]) ** 2
diattenuation = (Rs - Rp) / (Rs + Rp)

ratio = P_det / P_ideal
expected = R0 * 0.5 * (Rs + Rp)
print(f"detected power:            ideal {P_ideal:.4f} -> aluminum "
      f"{P_det:.4f}; ratio {ratio:.4f} "
      f"(R_Al(0) x R_Al(45) = {expected:.4f})")
print(f"instrumental polarization: DOP = {dop:.4f} "
      f"(45-deg diattenuation (Rs-Rp)/(Rs+Rp) = {abs(diattenuation):.4f})")
print(f"conservation error:        {res.power_conservation_error():.1e}")
assert res.power_conservation_error() < 1e-5
assert res_ideal.power_conservation_error() < 1e-5
assert abs(dop - abs(diattenuation)) < 0.008
assert abs(ratio - expected) < 0.02
