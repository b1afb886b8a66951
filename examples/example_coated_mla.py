"""AR-coated microlens array: instancing + single-layer thin-film coatings
(both extensions over the reference; SURVEY.md §8.5 lists neither as
reference capabilities).

A 4x4 plano-convex lenslet array focuses a collimated beam into a spot grid
on an image-plane detector. Run twice — bare lenslets vs quarter-wave
MgF2-coated — and compare delivered power: each lenslet has two
glass-air surfaces, so the coating's per-surface Fresnel saving (~4.3% ->
~1.3%) compounds to a few percent of end-to-end throughput.
"""

import os

import numpy as np

from lightpycl_tpu import instance_grid, optical_elements
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu.tracer.engine import Tracer
from lightpycl_tpu.utils import setup_logging

setup_logging()

RAY_COUNT = int(os.environ.get("RAY_COUNT", 200_000))

N, PITCH = 4, 0.30
WL = 0.55                      # design wavelength [um]
N_GLASS, N_FILM = 1.52, 1.38   # BK7-ish substrate, MgF2-ish film
H_QW = WL / (4 * N_FILM)       # quarter-wave thickness

oe = optical_elements(n_segments=48, n_radial=16)


def build(coated: bool):
    kw = dict(coat_ior=N_FILM, coat_thickness=H_QW) if coated else {}
    lenslet = oe.plano_convex_lens(r=0.15, aperture=0.20, thickness=0.05,
                                   ior=N_GLASS, **kw)
    mla = instance_grid(lenslet, N, N, PITCH, plane="xy", name="mla")
    det = oe.rectangle(N * PITCH + 0.4, N * PITCH + 0.4,
                       center=(0, 0, 0.40), material="measure", name="img")
    shell = oe.sphere(radius=5.0, material="terminator")
    return [mla, det, shell]


src = CollimatedSource(center=(0, 0, -0.5), direction=(0, 0, 1),
                       diameter=(N + 0.5) * PITCH, power=1.0,
                       ray_count=RAY_COUNT, wavelength=WL)

results = {}
for label, coated in (("bare", False), ("AR-coated", True)):
    res = Tracer().trace(
        src, build(coated), trace_iterations=6, mode="device",
        capacity=4 * RAY_COUNT,
        image_bins=96, image_center=(0, 0, 0.40),
        image_halfwidth=0.5 * N * PITCH + 0.1,
    )
    results[label] = res
    print(f"{label:10s}: delivered {res.ledger['measured']:.4f}  "
          f"ledger {res.ledger}")

gain = (results["AR-coated"].ledger["measured"]
        / max(results["bare"].ledger["measured"], 1e-30))
print(f"AR coating throughput gain: {gain:.4f}x")

img = results["AR-coated"].image
ny = img.shape[0]
top = np.argsort(img.ravel())[::-1][: N * N]
print(f"spot grid: top {N * N} pixels carry "
      f"{img.ravel()[top].sum() / img.sum():.2%} of the in-window power")
