"""GRIN rod lens (SELFOC): curved rays inside a gradient-index medium.

A rod with the radial-parabolic profile n(rho)^2 = n0^2 (1 - A rho^2)
(GeoObject(grin_a=A, axis=..., grin_center=...)) bends rays
continuously — the tracer advances them by exact SELFOC arc-length steps instead
of straight segments. Meridional paraxial rays follow the textbook
sinusoid r(z) = r0 cos(sqrt(A) z) with pitch P = 2 pi / sqrt(A), which
is why a quarter-pitch rod is a lens with both faces FLAT: the exact
geometry of SELFOC lens arrays in scanners and fiber collimators.

Anchors: the traced exit offsets reproduce r0 cos(sqrt(A) L) across a
sweep of rod lengths (the sinusoid, measured, not assumed); the
quarter-pitch rod focuses a collimated beam to a spot far below the
input radius; power conserved in every run.

    JAX_PLATFORMS=cpu python examples/example_grin.py
"""

import os

import numpy as np

from lightpycl_tpu import optical_elements
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu.tracer.engine import Tracer
from lightpycl_tpu.utils import setup_logging

setup_logging()

RAY_COUNT = int(os.environ.get("RAY_COUNT", 2000))
N0, A = 1.6, 4.0
PITCH = 2.0 * np.pi / np.sqrt(A)
R0 = 0.04  # probe-ray offset (paraxial: 8% of the profile radius)


def trace_rod(length, src, rays=64):
    oe = optical_elements()
    rod = oe.cube((1.2, 1.2, length), center=(0, 0, 1.0 + length / 2),
                  material="refractive", ior=N0, grin_a=A,
                  axis=(0, 0, 1), grin_center=(0, 0, 1.0))
    screen = oe.rectangle(width=10.0, depth=10.0,
                          center=(0, 0, 1.0 + length + 5e-3),
                          material="measure", name="exit")
    world = oe.sphere(radius=20.0, material="measure", name="world")
    res = Tracer().trace(src, [rod, screen, world],
                         trace_iterations=60, capacity=4 * rays)
    assert res.power_conservation_error() < 1e-4
    return res


print(f"SELFOC rod: n0 = {N0}, A = {A} -> pitch P = {PITCH:.4f}")
print("traced sinusoid r(L) vs r0 cos(sqrt(A) L):")
probe = CollimatedSource(center=(R0, 0, 0), direction=(0, 0, 1),
                         diameter=1e-6, power=1.0, ray_count=1)
for frac in (0.1, 0.25, 0.4, 0.5):
    length = frac * PITCH
    res = trace_rod(length, probe)
    sel = res.measured_det == 0
    j = int(np.argmax(res.measured_power[sel]))
    got = res.measured_pos[sel][j][0]
    want = R0 * np.cos(np.sqrt(A) * length)
    print(f"  L = {frac:4.2f} P: exit offset {got:+.5f} "
          f"(theory {want:+.5f})")
    assert abs(got - want) < 2e-3

beam = CollimatedSource(center=(0, 0, 0), direction=(0, 0, 1),
                        diameter=0.12, power=1.0, ray_count=RAY_COUNT)
res = trace_rod(PITCH / 4.0, beam, rays=RAY_COUNT)
sel = res.measured_det == 0
r = np.linalg.norm(res.measured_pos[sel][:, :2], axis=1)
pw = res.measured_power[sel]
spot = (r * pw).sum() / pw.sum()
print(f"quarter-pitch rod (flat faces!) focuses the 0.06-radius beam to "
      f"mean spot radius {spot:.4f}")
assert spot < 0.005
