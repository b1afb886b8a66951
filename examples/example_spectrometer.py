"""Grating spectrometer (diffraction-grating extension).

A collimated beam carrying two spectral lines hits a reflection grating
(1.2 um period, first order); the lines diffract to distinct angles
sin(theta) = lambda / period and land on separate spots of the detector
dome — a minimal spectrometer.

    JAX_PLATFORMS=cpu python examples/example_spectrometer.py
"""

import os

import numpy as np

from lightpycl_tpu import optical_elements
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu.tracer.engine import Tracer
from lightpycl_tpu.utils import setup_logging

setup_logging()
RAY_COUNT = int(os.environ.get("RAY_COUNT", 20_000))
PERIOD = 1.2  # um

oe = optical_elements(n_segments=32, n_radial=10)
els = [
    oe.rectangle(4.0, 4.0, material="grating", axis=(1, 0, 0),
                 grating_period=PERIOD, grating_order=1),
    oe.sphere(radius=5.0, material="measure", name="dome"),
]
# blue (F) and red (C) hydrogen lines, equal weight
src = CollimatedSource(center=(0, 0, 2.0), direction=(0, 0, -1),
                       diameter=0.5, power=1.0, ray_count=RAY_COUNT, seed=1,
                       wavelength=([0.4861, 0.6563], [1.0, 1.0]))

res = Tracer().trace(src, els, trace_iterations=3)
pos, wls = res.measured_pos, res.measured_wavelength
for line in (0.4861, 0.6563):
    sel = np.isclose(wls, line, atol=1e-3)
    sin_th = pos[sel, 0] / np.linalg.norm(pos[sel], axis=1)
    print(f"lambda={line} um: mean sin(theta)={sin_th.mean():.4f} "
          f"(grating equation: {line / PERIOD:.4f}), "
          f"power={res.measured_power[sel].sum():.4f}")
print(f"conservation error: {res.power_conservation_error():.2e}")

# full spectral response in ONE call: gratings make the geometry
# wavelength-dependent, so trace_spectral auto-dispatches to the
# wavelength-BATCHED method (the lambda axis flattens into the ray axis)
wl_grid = np.linspace(0.40, 0.70, 7)
src1 = CollimatedSource(center=(0, 0, 2.0), direction=(0, 0, -1),
                        diameter=0.5, power=1.0,
                        ray_count=min(RAY_COUNT, 5000), seed=1)
res_sp = Tracer().trace_spectral(src1, wl_grid, elements=els,
                                 trace_iterations=3)
spec = res_sp.detector_spectrum("dome") * len(wl_grid)
print("dome spectral response (batched dispersive trace):")
for wl, s in zip(wl_grid, spec):
    print(f"  {wl:.2f} um: {s:.4f}")
acc = sum(res_sp.ledger[k] for k in
          ("measured", "absorbed", "escaped", "culled"))
assert abs(acc + res_sp.final_live_power - res_sp.ledger["emitted"]) < 1e-4
# conservation holds PER WAVELENGTH too: each ledger column closes on its
# own lambda lane (live remainder = emitted - accounted per column)
lw = res_sp.spectral_ledger
acc_w = lw["measured"] + lw["absorbed"] + lw["escaped"] + lw["culled"]
assert (lw["emitted"] - acc_w >= -1e-5).all()
print("per-wavelength ledger closes: max open fraction "
      f"{(lw['emitted'] - acc_w).max():.2e} (live rays still tracing)")
