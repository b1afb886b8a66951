"""Traced field curves: astigmatism, field curvature, distortion.

The lens-report workflow `analysis.field_sweep` automates (round-5
feature, anchored by tests/test_field_sweep.py's Coddington check):
trace a collimated bundle at each field angle through a singlet with
the stop at the lens, and read off the curves an imaging designer
expects:

  * tangential/sagittal line foci (`analysis.line_foci`) — their split
    is the astigmatism, their mean track is the Petzval-ish field
    curvature;
  * best-focus z and RMS per field;
  * f-tan-theta distortion (near zero here: with the stop at a thin
    singlet the third-order Seidel distortion vanishes).

The traced Coddington shifts are compared against the third-order
prediction dz_t = -(3 S3 + S4) / (2 n' u'^2), dz_s = -(S3 + S4) /
(2 n' u'^2) from `paraxial.seidel` — trace and aberration theory meet
to a few percent at these apertures.

    JAX_PLATFORMS=cpu python examples/example_field_sweep.py
"""

import os

import numpy as np

import lightpycl_tpu as L
from lightpycl_tpu import paraxial as px
from lightpycl_tpu.analysis import field_sweep
from lightpycl_tpu.utils import setup_logging

setup_logging()

RAY_COUNT = int(os.environ.get("RAY_COUNT", 4096))

R1, R2, T, N = 0.8, -0.8, 0.2, 1.5
lens = L.analytic_lens(R1, R2, aperture=0.3, thickness=T, ior=N)
wall = L.analytic_sphere(10.0, material="measure", name="wall")
props = px.system_properties(px.thick_lens(R1, R2, T, N))
z_image = T + props["bfd"]
print(f"singlet: EFL={props['efl']:.4f}  image plane z={z_image:.4f}")

angles = np.radians([0.0, 3.0, 6.0, 9.0])
sw = field_sweep(lens + wall, angles, beam_diameter=0.06, z_image=z_image,
                 efl=props["efl"], source_dist=0.4, ray_count=RAY_COUNT,
                 trace_iterations=3, seed=3)

print(f"{'field':>7} {'chief y':>9} {'z_tan':>8} {'z_sag':>8} "
      f"{'z_best':>8} {'rms':>9} {'dist %':>8}")
for i, th in enumerate(angles):
    d = sw["distortion_pct"][i]
    print(f"{np.degrees(th):6.1f}° {sw['chief_height'][i]:9.5f} "
          f"{sw['z_tangential'][i]:8.4f} {sw['z_sagittal'][i]:8.4f} "
          f"{sw['z_best'][i]:8.4f} {sw['rms_best'][i]:9.2e} "
          f"{'—' if np.isnan(d) else f'{d:8.3f}'}")

# third-order cross-check at the largest field
th = angles[-1]
r = px.seidel([1 / R1, 1 / R2], [T], [1.0, N, 1.0], y=0.03, u=0.0,
              ybar=0.0, ubar=np.tan(th))
scale = 2.0 * r["n_out"] * r["u_out"] ** 2
pred_t = -(3.0 * r["S3"] + r["S4"]) / scale
pred_s = -(r["S3"] + r["S4"]) / scale
dz_t = sw["z_tangential"][-1] - sw["z_tangential"][0]
dz_s = sw["z_sagittal"][-1] - sw["z_sagittal"][0]
print(f"\nCoddington check at {np.degrees(th):.0f}°: "
      f"traced dz_t={dz_t:+.5f} (Seidel {pred_t:+.5f}), "
      f"dz_s={dz_s:+.5f} (Seidel {pred_s:+.5f})")
assert abs(dz_t - pred_t) < 0.12 * abs(pred_t)
assert abs(dz_s - pred_s) < 0.12 * abs(pred_s)
assert (sw["detected_power"] > 0.85).all()
assert abs(sw["distortion_pct"][1]) < 2.0  # stop at the lens: S5 ~ 0
print("ok: traced field curves match third-order aberration theory")
