"""Coating spectrometry in ONE trace: wavelength-parallel tracing.

A quarter-wave (HL)^3 high-reflector on glass is illuminated at normal
incidence; 32 spectral samples ride each geometric ray (lightpycl_tpu.
spectral), so the full R(lambda) curve — stopband and sidelobes — comes out
of a single geometry pass. The measured spectrum is checked against the
analytic transfer-matrix reflectance, and the wall-clock is compared with
the scalar alternative (32 independent traces).

    JAX_PLATFORMS=cpu python examples/example_spectral_coating.py
"""

import os
import time

import jax.numpy as jnp
import numpy as np

from lightpycl_tpu import optical_elements
from lightpycl_tpu.physics import multilayer_reflectance
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu.tracer.engine import Tracer
from lightpycl_tpu.tracer.rays import RayBatch
from lightpycl_tpu.utils import setup_logging

setup_logging()

RAY_COUNT = int(os.environ.get("RAY_COUNT", 50_000))
N_WL = int(os.environ.get("N_WL", 32))
N_HI, N_LO, N_SUB = 2.35, 1.46, 1.52          # TiO2 / SiO2 on glass
WL0 = 0.55                                     # design wavelength [um]
STACK = [(N_HI, WL0 / (4 * N_HI)), (N_LO, WL0 / (4 * N_LO))] * 3

oe = optical_elements(n_segments=48, n_radial=16)
mirror_el = oe.cube(size=(1.2, 1.2, 0.3), material="refractive", ior=N_SUB,
                    coating=STACK, name="hr")
fwd = oe.disc(radius=2.0, center=(0, 0, 2.0), material="measure", name="T")
back = oe.disc(radius=2.0, center=(0, 0, -2.0), material="measure", name="R")
shell = oe.sphere(radius=8.0, material="terminator")
els = [mirror_el, fwd, back, shell]

src = CollimatedSource(center=(0, 0, -1.0), direction=(0, 0, 1),
                       diameter=0.6, ray_count=RAY_COUNT, power=1.0, seed=7)
o, d, p = src.sample()
rays = RayBatch.from_arrays(o, d, p, capacity=4 * RAY_COUNT)

wls = np.linspace(0.40, 0.75, N_WL)

# engine API: one call, same TraceResult surface as a scalar trace plus
# the (D, W) spectra (equivalently: CL_Tracer().iterative_tracer(...,
# wavelengths=wls) from a ported reference script)
tr = Tracer()
res_sp = tr.trace_spectral(src, wls, elements=els, trace_iterations=10,
                           rays=rays)
t_spectral = res_sp.wall_time
print(f"spectral trace: {N_WL} wavelengths x {RAY_COUNT} rays "
      f"in {t_spectral:.2f}s (one geometry pass)")

W = len(wls)
R_meas = res_sp.detector_spectrum("R") * W     # columns carry 1/W power
T_meas = res_sp.detector_spectrum("T") * W
# the scalar analysis surface exists too: angular histogram + ledger
assert abs(res_sp.hist.sum() - res_sp.ledger["measured"]) < 1e-5

# analytic single-interface comparison: at normal incidence the measured
# backward power is R1 + T1^2 R2 + ... (both faces coated); the front
# interface dominates inside the stopband
arr = jnp.asarray
# jit: one compiled call instead of eager ops
import jax as _jax

_ml = _jax.jit(multilayer_reflectance)
R1 = np.array([float(_ml(
    arr([1.0]), arr([1.0]), [arr([n]) for n, _ in STACK],
    [arr([h]) for _, h in STACK], arr([N_SUB]), arr([wl]))[0])
    for wl in wls])

print(f"{'wl[um]':>7} {'R_traced':>9} {'R1_analytic':>11} {'T_traced':>9}")
for k in range(0, W, 4):
    print(f"{wls[k]:7.3f} {R_meas[k]:9.4f} {R1[k]:11.4f} {T_meas[k]:9.4f}")
peak = R_meas.argmax()
print(f"stopband peak: R = {R_meas[peak]:.4f} at {wls[peak]:.3f} um "
      f"(design {WL0} um); analytic front-interface R1 = {R1[peak]:.4f}")
assert abs(wls[peak] - WL0) < 0.03
assert R_meas[peak] > 0.68          # (HL)^3: R1 ~ 0.70 + back-face return

# scalar-alternative timing: the same scene traced at ONE wavelength,
# scaled by W (lower bound: W independent traces, W compiles amortized out)
res = tr.trace(src, els, trace_iterations=10,
               rays=RayBatch.from_arrays(o, d, p, capacity=4 * RAY_COUNT,
                                         wavelengths=WL0),
               mode="device", dissipation_target=1.0)
t_one = res.wall_time
print(f"scalar trace at one wavelength: {t_one:.2f}s -> x{N_WL} = "
      f"{N_WL * t_one:.1f}s for the same spectrum; spectral speedup "
      f"~{N_WL * t_one / t_spectral:.1f}x (small sizes are compile-"
      "dominated; benchmarks/spectral_bench.py measures steady state)")
