"""BASELINE config 1: point source + ideal parabolic mirror collimator,
100k rays, hemisphere detector.

Reference parity: the canonical LightPyCL example (SURVEY.md §3 'Examples')
— a point source with cos-directivity at the focus of a parabolic mirror,
collimated into a measurement hemisphere; directivity plotted and the scene
exported to DXF.
"""

import os

import numpy as np

from lightpycl_tpu.compat import CL_Tracer, light_source, optical_elements
from lightpycl_tpu.utils import setup_logging

setup_logging()

RAY_COUNT = int(os.environ.get("RAY_COUNT", 100_000))

oe = optical_elements(n_segments=128, n_radial=32)
mirror = oe.parabolic_mirror(focus=0.5, diameter=2.0, reflectivity=0.98)
dome = oe.hemisphere(radius=50.0, name="dome")

ls = light_source(
    center=(0, 0, 0.5), direction=(0, 0, -1),
    directivity=lambda az, pol: np.cos(pol),
    power=1.0, ray_count=RAY_COUNT,
)

tracer = CL_Tracer(platform_name="", device_type="GPU")
res = tracer.iterative_tracer(ls, [mirror, dome], trace_iterations=8,
                              max_ray_len=1e3, ior_env=1.0)

pos, dirs, powers = tracer.get_measured_rays()
print(f"measured rays: {len(powers)}  detected power: {powers.sum():.6f}")
print(f"ledger: {tracer.get_power_ledger()}")
print(f"beam: {tracer.get_beam_statistics()}")
print(f"perf: {tracer.get_trace_performance()}")

out = os.environ.get("OUT_DIR", ".")
try:
    tracer.plot_measured_directivity(path=os.path.join(out, "directivity.png"))
    print("wrote directivity.png")
except Exception as e:  # matplotlib optional
    print(f"plot skipped: {e}")
tracer.save_traced_scene(os.path.join(out, "parabolic_scene.dxf"))
print("wrote parabolic_scene.dxf")
