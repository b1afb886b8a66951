"""Birefringence demo (uniaxial-crystal extension, opt-in): a calcite
plate at normal incidence splits unpolarized light into the undeviated
ordinary beam and the walked-off extraordinary beam — the classic
double-image experiment. Crossing the input polarization steers all power
between the two spots (Malus), and the o/e OPL difference is the plate's
retardation."""

import os

import numpy as np

import lightpycl_tpu as L
from lightpycl_tpu import materials
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu.tracer.engine import Tracer
from lightpycl_tpu.utils import setup_logging

setup_logging()

RAY_COUNT = int(os.environ.get("RAY_COUNT", 20_000))

n_o, n_e = materials.CALCITE
H = 10.0                       # plate thickness [mm-ish scene units]
theta = np.pi / 4              # optic axis at 45 deg in the x-z plane

oe = L.optical_elements()
plate = oe.cube((30.0, 30.0, H), center=(0, 0, H / 2 + 1.0),
                material="birefringent", ior=n_o, ne=n_e,
                axis=(np.sin(theta), 0.0, np.cos(theta)))
screen = oe.rectangle(width=60.0, depth=60.0, center=(0, 0, 30.0),
                      material="measure", name="screen")

src = CollimatedSource(center=(0, 0, 0), direction=(0, 0, 1),
                       diameter=0.5, power=1.0, ray_count=RAY_COUNT)

res = Tracer().trace(src, [plate, screen], trace_iterations=10,
                     capacity=8 * RAY_COUNT, polarization=True)
print(f"ledger: {res.ledger}")

xs = res.measured_pos[:, 0]
p = res.measured_power
o_spot = np.abs(xs) < 0.6
print(f"o spot: power {p[o_spot].sum():.4f} at x ~ 0 (undeviated)")
print(f"e spot: power {p[~o_spot].sum():.4f} at x ~ "
      f"{np.average(xs[~o_spot], weights=p[~o_spot]):+.4f}")

# theory: walk-off angle and displacement
n_th = 1.0 / np.sqrt(np.cos(theta) ** 2 / n_o ** 2
                     + np.sin(theta) ** 2 / n_e ** 2)
rho = np.arctan(n_th ** 2 / 2 * (1 / n_e ** 2 - 1 / n_o ** 2)
                * np.sin(2 * theta))
print(f"theory: walk-off {np.degrees(rho):.3f} deg -> displacement "
      f"{-H * np.tan(rho):+.4f} (negative uniaxial walks away from the "
      "axis tilt)")

# retardation: the o/e optical-path difference through the plate
opl_o = res.measured_opl[o_spot].min()
opl_e = res.measured_opl[~o_spot].min()
print(f"OPL: o {opl_o:.4f}, e {opl_e:.4f}; retardation "
      f"{opl_o - opl_e:.4f} (theory (n_o - n(theta)) H = "
      f"{(n_o - n_th) * H:.4f})")

# polarized input: all power into one beam
for s1, name in [(1.0, "o (basis-aligned)"), (-1.0, "e (crossed)")]:
    src_p = CollimatedSource(center=(0, 0, 0), direction=(0, 0, 1),
                             diameter=0.5, power=1.0, ray_count=4096,
                             stokes=(s1, 0.0, 0.0))
    r = Tracer().trace(src_p, [plate, screen], trace_iterations=10,
                       capacity=32768, polarization=True)
    x = r.measured_pos[:, 0]
    q = r.measured_power
    print(f"linear s1={s1:+.0f}: o spot {q[np.abs(x) < 0.6].sum():.4f}, "
          f"e spot {q[np.abs(x) >= 0.6].sum():.4f}   -> {name}")
