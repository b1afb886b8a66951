"""First- and third-order aberration analysis closed-loop with the tracer.

The paraxial module (`lightpycl_tpu.paraxial`) predicts a system's
aberrations in microseconds from its prescription alone — Seidel sums
S1..S5 plus the chromatic sums CL/CT — and the exact-surface tracer
confirms them ray by ray:

 1. SF10 singlet: Seidel spherical (LSA), Coddington field curves
    (tangential/sagittal), and axial color, each vs the traced value.
 2. Achromatic doublet design: solve phi_i/V_i = 0 for BK7 + F2, show
    CL collapses by ~3 orders, then TRACE both lenses at the F and C
    lines — the doublet's measured focal shift shrinks accordingly.

    JAX_PLATFORMS=cpu python examples/example_aberrations.py
"""

import os

import numpy as np

import lightpycl_tpu as L
from lightpycl_tpu import materials as mats
from lightpycl_tpu import paraxial as px
from lightpycl_tpu.analysis import best_focus
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu.tracer.engine import Tracer

RAY_COUNT = int(os.environ.get("RAY_COUNT", 1024))

# ------------------------------------------------------------- singlet
N_D, V = 1.7280, 28.53                       # SF10
A_CAU, B_CAU = mats.glass(N_D, V)
R1, R2, T = 0.8, -0.8, 0.2
nF = A_CAU + B_CAU / mats.F_LINE ** 2
nC = A_CAU + B_CAU / mats.C_LINE ** 2

s = px.seidel([1 / R1, 1 / R2], [T], [1.0, N_D, 1.0],
              y=0.05, u=0.0, ybar=0.0, ubar=0.1,
              delta_n=[0.0, nF - nC, 0.0])
u2 = s["u_out"]
print("SF10 singlet Seidel sums (y=0.05, field 0.1 rad, stop at lens):")
for key in ("S1", "S2", "S3", "S4", "S5"):
    print(f"  {key} = {s[key]: .3e}")
print(f"  CL = {s['CL']: .3e}   H = {s['H']:.4f}")
print(f"  predicted LSA          = {-s['S1'] / (2 * u2 * u2): .5f}")
print(f"  predicted dz_tangential = {-(3 * s['S3'] + s['S4']) / (2 * u2 * u2): .5f}")
print(f"  predicted dz_sagittal   = {-(s['S3'] + s['S4']) / (2 * u2 * u2): .5f}")
print(f"  predicted dz(F-C) color = {-s['CL'] / (u2 * u2): .5f}")

tracer = Tracer()


def traced_focus(elements, wavelength=None, theta=0.0, diameter=0.1):
    d = np.array([0.0, np.sin(theta), np.cos(theta)])
    src = CollimatedSource(center=tuple(-0.4 * d), direction=tuple(d),
                           diameter=diameter, power=1.0, ray_count=RAY_COUNT,
                           seed=7, wavelength=wavelength)
    res = tracer.trace(src, elements, trace_iterations=6,
                       capacity=4 * RAY_COUNT)
    fwd = np.asarray(res.measured_dir[:, 2] > 0.5)
    return best_focus(np.asarray(res.measured_pos)[fwd],
                      np.asarray(res.measured_dir)[fwd],
                      np.asarray(res.measured_power)[fwd],
                      z_range=(0.3, 1.4))[0]


def make_singlet():
    oe = L.optical_elements(n_segments=96, n_radial=48)
    lens = oe.spherical_lens(R1, R2, aperture=0.4, thickness=T, ior=A_CAU)
    lens.dispersion_b = B_CAU
    wall = oe.sphere(radius=10.0, material="measure", name="wall")
    return [lens, wall]


singlet = make_singlet()
zF = traced_focus(singlet, wavelength=mats.F_LINE)
zC = traced_focus(singlet, wavelength=mats.C_LINE)
shift_singlet = zF - zC
print(f"\ntraced singlet focus:  F line {zF:.5f}  C line {zC:.5f}  "
      f"shift {shift_singlet: .5f}  (predicted {-s['CL'] / (u2 * u2): .5f})")

# ------------------------------------------------- achromatic doublet
ND1, V1 = 1.5168, 64.17                      # N-BK7 crown
ND2, V2 = 1.6200, 36.37                      # F2 flint
PHI = 1.0 / px.system_properties(px.thick_lens(R1, R2, T, N_D))["efl"]
phi1 = PHI * V1 / (V1 - V2)
phi2 = -PHI * V2 / (V1 - V2)
print(f"\nachromat design for the same power {PHI:.3f}: "
      f"phi_crown {phi1:.3f}, phi_flint {phi2:.3f}")

dc1 = phi1 / (ND1 - 1.0)
dc2 = phi2 / (ND2 - 1.0)
a1, b1 = mats.glass(ND1, V1)
a2, b2 = mats.glass(ND2, V2)
dn1 = (a1 + b1 / mats.F_LINE ** 2) - (a1 + b1 / mats.C_LINE ** 2)
dn2 = (a2 + b2 / mats.F_LINE ** 2) - (a2 + b2 / mats.C_LINE ** 2)
sd = px.seidel([dc1 / 2, -dc1 / 2, dc2 / 2, -dc2 / 2], [1e-9] * 3,
               [1.0, ND1, 1.0, ND2, 1.0], y=0.05, u=0.0,
               ybar=0.0, ubar=0.1,
               delta_n=[0.0, dn1, 0.0, dn2, 0.0])
print(f"paraxial CL: singlet {s['CL']:.3e}  doublet {sd['CL']:.3e} "
      f"({abs(s['CL'] / max(abs(sd['CL']), 1e-30)):.0e}x smaller)")


def make_doublet():
    """Air-spaced equiconvex crown + biconcave flint, thin gap. The
    crown's radii are steep (~0.26), so the doublet aperture is smaller
    than the singlet's."""
    oe = L.optical_elements(n_segments=96, n_radial=48)
    t1, t2, gap = 0.08, 0.04, 0.01
    crown = oe.spherical_lens(2.0 / dc1, -2.0 / dc1, aperture=0.22,
                              thickness=t1, ior=a1)
    crown.dispersion_b = b1
    flint = oe.spherical_lens(2.0 / dc2, -2.0 / dc2, aperture=0.22,
                              thickness=t2, ior=a2,
                              center=(0, 0, t1 + gap))
    flint.dispersion_b = b2
    wall = oe.sphere(radius=10.0, material="measure", name="wall")
    return [crown, flint, wall]


doublet = make_doublet()
zF2 = traced_focus(doublet, wavelength=mats.F_LINE, diameter=0.07)
zC2 = traced_focus(doublet, wavelength=mats.C_LINE, diameter=0.07)
shift_doublet = zF2 - zC2
print(f"traced doublet focus:  F line {zF2:.5f}  C line {zC2:.5f}  "
      f"shift {shift_doublet: .5f}")
ratio = abs(shift_singlet) / max(abs(shift_doublet), 1e-9)
print(f"traced chromatic focal shift suppressed {ratio:.0f}x by the achromat")
assert abs(shift_doublet) < 0.25 * abs(shift_singlet), (
    "achromat should suppress the chromatic focal shift by >4x")
print("OK")
