"""Differentiable anti-reflection coating design.

The tracer's thin-film model (physics.multilayer_rs_rp — the same Airy
recursion every coated hit evaluates on device) is pure jnp, so jax.grad
differentiates the band-averaged reflectance of a stack with respect to
every layer index and thickness. diff.design_coating turns that into a
coating designer; the optimized [(n, h), ...] list feeds straight back
into GeoObject(coating=...) and is traced by the same math it was
designed with. The PyOpenCL reference has no film model at all.

Three demos:
 1. Textbook single-layer AR: free (n, h) at 550 nm on BK7 converges to
    the analytic optimum n* = sqrt(n_sub), h* = lambda/(4 n*), R = 0.
 2. Catalog V-coat: MgF2/ZrO2 thicknesses on BK7 null the 550 nm
    reflection exactly (indices a real coating shop can deposit).
 3. Broadband 4-layer design over 420-680 nm, then an end-to-end trace:
    a biconvex lens wearing the designed stack vs the bare lens — the
    detected power gain is the designed reflectance, realized in the
    ray tracer.

    JAX_PLATFORMS=cpu python examples/example_coating_design.py
"""

import os
import time

import numpy as np

import lightpycl_tpu as L
from lightpycl_tpu.diff import band_reflectance, design_coating
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu.tracer.engine import Tracer

N_SUB = 1.52          # BK7-ish
WL0 = 0.55            # design wavelength [um]
STEPS = int(os.environ.get("OPT_STEPS", 1200))

# ---------------------------------------------------------------- demo 1
print("=== demo 1: single-layer AR, free (n, h) at 550 nm on BK7")
t0 = time.perf_counter()
n1, h1, r1 = design_coating(1, n_sub=N_SUB, wavelengths=[WL0],
                            steps=STEPS, lr=0.02)
n_star = np.sqrt(N_SUB)
print(f"  designed n = {n1[0]:.5f}  (analytic sqrt(n_sub) = {n_star:.5f})")
print(f"  designed h = {h1[0] * 1e3:.2f} nm  "
      f"(analytic lambda/4n* = {WL0 / (4 * n_star) * 1e3:.2f} nm)")
print(f"  residual R = {r1:.2e}   [{time.perf_counter() - t0:.1f}s]")
assert abs(n1[0] - n_star) < 5e-3 and r1 < 1e-7

# ---------------------------------------------------------------- demo 2
print("=== demo 2: MgF2/ZrO2 V-coat (thickness-only, catalog indices)")
nV, hV, rV = design_coating(2, n_sub=N_SUB, wavelengths=[WL0],
                            fixed_n=[1.38, 2.10], steps=STEPS, lr=0.02)
print(f"  thicknesses = {hV[0] * 1e3:.1f} nm MgF2 / {hV[1] * 1e3:.1f} nm "
      f"ZrO2 -> R(550nm) = {rV:.2e}")
assert rV < 1e-7

# ---------------------------------------------------------------- demo 3
print("=== demo 3: broadband 4-layer AR, 420-680 nm, traced on a lens")
wls = np.linspace(0.42, 0.68, 14)
r_bare = float(band_reflectance([1.38], [0.0], n_sub=N_SUB,
                                wavelengths=wls))
r_mgf2 = float(band_reflectance([1.38], [WL0 / (4 * 1.38)], n_sub=N_SUB,
                                wavelengths=wls))
n4, h4, r4 = design_coating(4, n_sub=N_SUB, wavelengths=wls,
                            fixed_n=[1.38, 2.10, 1.38, 2.10],
                            steps=STEPS, lr=0.02)
print(f"  mean band R: bare {r_bare * 100:.2f}%  "
      f"qw-MgF2 {r_mgf2 * 100:.2f}%  designed {r4 * 100:.2f}%")
stack = [(float(n), float(h)) for n, h in zip(n4, h4)]
print("  stack:", " | ".join(f"n={n:.2f} h={h * 1e3:.1f}nm"
                             for n, h in stack))

oe = L.optical_elements(n_segments=32, n_radial=12)


def lens_scene(coating):
    kw = dict(coating=coating) if coating else {}
    lens = oe.biconvex_lens(0.9, 0.5, 0.12, ior=N_SUB, **kw)
    # forward disc sees only the transmitted beam; backward Fresnel
    # ghosts die on the absorbing shell, so the detected power IS the
    # two-surface transmission
    img = oe.disc(radius=1.5, center=(0, 0, 2.0), material="measure",
                  name="img")
    shell = oe.sphere(radius=8.0, material="terminator")
    return [lens, img, shell]


src = CollimatedSource(center=(0, 0, -0.8), direction=(0, 0, 1),
                       diameter=0.5, ray_count=4096, power=1.0, seed=7,
                       wavelength=(wls, np.ones_like(wls)))


def traced_power(coating):
    o, d, p = src.sample()
    wl = src.sample_wavelengths()
    from lightpycl_tpu.tracer.rays import RayBatch

    rays = RayBatch.from_arrays(o, d, p, wavelengths=wl, capacity=16384)
    return Tracer().trace(src, lens_scene(coating), trace_iterations=8,
                          rays=rays).detector_power("img")

t_bare = traced_power(None)
t_coat = traced_power(stack)
print(f"  traced detected power (white beam, 2-surface lens): "
      f"bare {t_bare:.4f} -> coated {t_coat:.4f} "
      f"(+{(t_coat - t_bare) * 100:.2f}%)")
assert t_coat > t_bare
print("designed-and-traced: the coating designer and the tracer share "
      "one film model.")
