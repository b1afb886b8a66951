"""Polarization demo (Stokes-Mueller extension, opt-in): a Brewster-angle
glass plate splits unpolarized light into a fully s-polarized reflection
and a partially p-polarized transmission."""

import os

import numpy as np

import lightpycl_tpu as L
from lightpycl_tpu.analysis import degree_of_polarization
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu.tracer.engine import Tracer
from lightpycl_tpu.utils import setup_logging

setup_logging()

RAY_COUNT = int(os.environ.get("RAY_COUNT", 20_000))

n = 1.5
brewster = np.arctan(n)  # 56.31 deg for n = 1.5

oe = L.optical_elements(n_segments=24, n_radial=8)
plate = oe.cube((4, 4, 0.2), center=(0, 0, 0.1)).rotate((0, 1, 0), brewster)
plate.material = L.Material.REFRACTIVE
plate.ior = n
dome = oe.sphere(12.0, material="measure", name="dome")

src = CollimatedSource(center=(0, 0, -2), direction=(0, 0, 1),
                       diameter=0.5, power=1.0, ray_count=RAY_COUNT)

res = Tracer().trace(src, [plate, dome], trace_iterations=8,
                     capacity=8 * RAY_COUNT, polarization=True)
print(f"ledger: {res.ledger}")

# separate the reflected bundle (strongly deflected, dx < -0.7) from the
# transmitted one
dx = res.measured_dir[:, 0]
refl = dx < -0.7
tran = ~refl
p = res.measured_power
print(f"reflected power:   {p[refl].sum():.4f}  "
      f"DOP = {degree_of_polarization(res.measured_stokes[refl], p[refl]):.4f} "
      f"(Brewster: fully s-polarized -> 1.0)")
print(f"transmitted power: {p[tran].sum():.4f}  "
      f"DOP = {degree_of_polarization(res.measured_stokes[tran], p[tran]):.4f} "
      f"(partially p-polarized)")
ci = np.cos(brewster)
ct = np.cos(np.arcsin(np.sin(brewster) / n))
rs = ((ci - n * ct) / (ci + n * ct)) ** 2
print(f"theory: single-surface Rs = {rs:.4f}; unpolarized beam reflects "
      f"Rs/2 = {rs / 2:.4f} per surface (two surfaces at Brewster)")
