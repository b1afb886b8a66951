"""BASELINE config 2: plano-convex lens — refraction + Fresnel transmission
loss, focal-plane intensity map, 1M rays.

The intensity map accumulates ON DEVICE (TraceConfig.image_bins): the whole
1M-ray multi-bounce trace is one XLA computation and only the (bins, bins)
image + ledger return to the host."""

import os

import numpy as np

from lightpycl_tpu import optical_elements
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu.tracer.engine import Tracer
from lightpycl_tpu.utils import setup_logging

setup_logging()

RAY_COUNT = int(os.environ.get("RAY_COUNT", 1_000_000))

n, r, thickness = 1.5, 0.5, 0.1
f = r / (n - 1.0)  # lensmaker, flat front

oe = optical_elements(n_segments=128, n_radial=48)
lens = oe.plano_convex_lens(r=r, aperture=0.6, thickness=thickness, ior=n)
focal_plane = oe.disc(radius=0.5, center=(0, 0, thickness + f),
                      material="measure", name="focal_plane")
enclosure = oe.sphere(radius=10.0, material="terminator", name="enclosure")

src = CollimatedSource(center=(0, 0, -0.5), direction=(0, 0, 1),
                       diameter=0.4, power=1.0, ray_count=RAY_COUNT)

tracer = Tracer()
res = tracer.trace(
    src, [lens, focal_plane, enclosure], trace_iterations=6, mode="device",
    image_bins=128, image_center=(0, 0, thickness + f),
    image_normal=(0, 0, 1), image_halfwidth=0.05,
)

print(f"ledger: {res.ledger}")
R0 = ((n - 1) / (n + 1)) ** 2
print(f"detected {res.ledger['measured']:.4f} vs (1-R0)^2 = {(1 - R0) ** 2:.4f}")

img = res.image
peak = np.unravel_index(img.argmax(), img.shape)
print(f"focal-plane intensity map ({img.shape[0]}x{img.shape[1]}): "
      f"peak bin {peak}, in-window power {img.sum():.4f}, "
      f"peak fraction {img.max() / max(img.sum(), 1e-30):.3f}")
print(f"perf: {res.tests_per_second:.3g} tests/s, {res.rays_per_second:.3g} rays/s")
