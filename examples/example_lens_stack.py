"""BASELINE config 3: two-element dielectric lens stack with reflect+refract
ray splitting, 5 trace iterations, compaction between bounces."""

import os

from lightpycl_tpu.compat import CL_Tracer, optical_elements
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu.utils import setup_logging

setup_logging()

RAY_COUNT = int(os.environ.get("RAY_COUNT", 200_000))

oe = optical_elements(n_segments=96, n_radial=32)
l1 = oe.biconvex_lens(1.0, 0.8, 0.2, ior=1.5)
l2 = oe.biconvex_lens(1.5, 0.8, 0.15, ior=1.7).translate((0, 0, 0.5))
enclosure = oe.sphere(radius=6.0, material="measure", name="enclosure")

src = CollimatedSource(center=(0, 0, -0.5), direction=(0, 0, 1),
                       diameter=0.5, power=1.0, ray_count=RAY_COUNT)

tracer = CL_Tracer()
res = tracer.iterative_tracer(
    src, [l1, l2, enclosure], trace_iterations=5,
    capacity=4 * RAY_COUNT,  # headroom for Fresnel-split children
    record_paths=False,
)

print(f"ledger: {res.ledger}")
print(f"measured ray count {len(res.measured_power)} from {RAY_COUNT} emitted "
      f"(> emitted means splitting)")
acc = sum(res.ledger[k] for k in ("measured", "absorbed", "escaped", "culled"))
print(f"power accounted after 5 iterations: {acc:.6f} / {res.ledger['emitted']:.6f}")
print(f"perf: {tracer.get_trace_performance()}")
