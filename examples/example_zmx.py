"""Zemax .zmx prescription import: design-file round trip.

Workflow a lens designer migrating from OpticStudio would follow:

  1. write (or receive) a sequential .zmx prescription — here an
     air-spaced BK7 + F2 achromat designed from the paraxial chromatic
     sums (phi_i / V_i = 0), saved with `save_zmx`;
  2. `load_zmx` it back and fold it into a paraxial ABCD matrix
     (`zmx_paraxial`) for the first-order expectation: EFL / BFD;
  3. `zmx_to_scene` it into traceable elements (catalog Sellmeier
     dispersion attached automatically) and trace a collimated beam;
  4. confirm the traced best focus lands at the paraxial image plane
     and that the achromat's F-vs-C focal shift is suppressed vs an
     equivalent singlet.

    JAX_PLATFORMS=cpu python examples/example_zmx.py
"""

import math
import os
import tempfile

import numpy as np

from lightpycl_tpu import materials, paraxial
from lightpycl_tpu.analysis import best_focus
from lightpycl_tpu.io import load_zmx, save_zmx, zmx_paraxial, zmx_to_scene
from lightpycl_tpu.io.zmx import ZmxPrescription, ZmxSurface
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu.tracer.config import TraceConfig
from lightpycl_tpu.tracer.engine import Tracer
from lightpycl_tpu.utils import setup_logging

setup_logging()

RAY_COUNT = int(os.environ.get("RAY_COUNT", 20_000))
WL_D, WL_F, WL_C = materials.D_LINE, materials.F_LINE, materials.C_LINE

# ---------------------------------------------------------------- design
# Achromat: total power PHI split over BK7 crown + F2 flint so the
# first-order chromatic sum vanishes: phi1/V1 + phi2/V2 = 0.
EFL = 100.0  # mm
V1, V2 = 64.17, 36.37         # Abbe numbers (BK7, F2)
n1 = float(materials.sellmeier_index(WL_D, "N-BK7"))
n2 = float(materials.sellmeier_index(WL_D, "F2"))
phi = 1.0 / EFL
phi1 = phi * V1 / (V1 - V2)   # crown (positive)
phi2 = phi * V2 / (V2 - V1)   # flint (negative)
# equiconvex crown, and a flint whose front matches the crown's back
R1 = 2.0 * (n1 - 1.0) / phi1
R2, R3 = -R1, None            # flint: front -R1, rear flat via thin-lens
R3 = 1.0 / (1.0 / R2 - phi2 / (n2 - 1.0))
t1, t2, gap = 4.0, 2.5, 0.5

presc = ZmxPrescription(
    name="BK7+F2 achromat f=100",
    unit="MM",
    wavelengths_um=[WL_F, WL_D, WL_C],
    primary_wl_index=2,
    enpd=20.0,
    surfaces=[
        ZmxSurface(0, disz=math.inf),
        ZmxSurface(1, curv=1.0 / R1, disz=t1, glass="N-BK7", semi_diam=11.0,
                   comment="crown"),
        ZmxSurface(2, curv=1.0 / R2, disz=gap, semi_diam=11.0),
        ZmxSurface(3, curv=1.0 / R2, disz=t2, glass="F2", semi_diam=11.0,
                   comment="flint"),
        ZmxSurface(4, curv=1.0 / R3, disz=0.0, semi_diam=11.0),  # BFD below
        ZmxSurface(5, semi_diam=4.0),
    ],
)

# place the image plane at the d-line paraxial BFD
props = zmx_paraxial(presc)
presc.surfaces[4].disz = props["bfd"]
print(f"paraxial: EFL {props['efl']:.3f} mm  BFD {props['bfd']:.3f} mm "
      f"(design EFL {EFL:.1f})")

path = os.path.join(tempfile.gettempdir(), "achromat.zmx")
save_zmx(path, presc)
reloaded = load_zmx(path)
print(f"wrote + reloaded {path}: {len(reloaded.surfaces)} surfaces, "
      f"primary wavelength {reloaded.primary_wavelength_um} um")

# ---------------------------------------------------------------- trace
elements, info = zmx_to_scene(reloaded, n_segments=128, n_radial=48,
                              detector_scale=2.0)
print(f"scene: {[e.name for e in elements]}  image at z={info['z_image']:.3f}")


def traced_focus(wl_um):
    els, inf_ = zmx_to_scene(reloaded, wavelength_um=wl_um,
                             n_segments=128, n_radial=48, detector_scale=2.0)
    src = CollimatedSource(center=(0, 0, -5.0), direction=(0, 0, 1),
                           diameter=10.0, power=1.0, ray_count=RAY_COUNT,
                           seed=11)
    res = Tracer(TraceConfig()).trace(src, els, trace_iterations=6,
                                      capacity=4 * RAY_COUNT)
    fwd = res.measured_dir[:, 2] > 0.5
    z, rms = best_focus(res.measured_pos[fwd], res.measured_dir[fwd],
                        res.measured_power[fwd],
                        z_range=(inf_["z_image"] - 15, inf_["z_image"] + 15))
    return z, rms, float(res.measured_power[fwd].sum())


z_d, rms_d, p_d = traced_focus(WL_D)
z_f, _, _ = traced_focus(WL_F)
z_c, _, _ = traced_focus(WL_C)
print(f"traced d-line focus {z_d:.3f} mm (paraxial image {info['z_image']:.3f}),"
      f" spot rms {rms_d:.4f} mm, detected {p_d:.3f}")
shift = z_f - z_c
print(f"traced F-C focal shift {shift:+.4f} mm "
      f"(singlet of the same power would shift ~{-EFL / V1:.3f} mm)")

assert abs(z_d - info["z_image"]) < 2.5, (z_d, info["z_image"])
assert p_d > 0.75
assert abs(shift) < 0.5 * EFL / V1, shift  # achromatized vs the singlet
print("example_zmx OK")
