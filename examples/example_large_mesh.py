"""BASELINE config 4: large-mesh scene (>=100k triangles) with a directional
source, 100M rays batched through device memory.

Uses Tracer.trace_batched: rays are generated ON DEVICE (jax.random) in
mega-batches so the host never stages 100M x 32B of ray state; the
intersect kernel streams the triangle transforms tile by tile; the run
checkpoints after every batch and resumes if interrupted
(delete large_mesh_ckpt.npz in the temp directory to restart).
"""

import os
import tempfile

import lightpycl_tpu as L
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu.tracer.config import TraceConfig
from lightpycl_tpu.tracer.engine import Tracer
from lightpycl_tpu.utils import setup_logging

setup_logging()

TOTAL_RAYS = int(os.environ.get("TOTAL_RAYS", 100_000_000))
BATCH = int(os.environ.get("BATCH", 4_000_000))
CKPT = os.environ.get("CKPT", os.path.join(tempfile.gettempdir(),
                                           "large_mesh_ckpt.npz"))

# >=100k triangle scene: finely tessellated mirror bowl + detector dome
seg = int(os.environ.get("MESH_SEGMENTS", 360))
oe = L.optical_elements(n_segments=seg, n_radial=seg // 2)
bowl = oe.parabolic_mirror(focus=1.0, diameter=4.0, reflectivity=0.95)
dome = L.optical_elements(n_segments=128, n_radial=32).hemisphere(
    radius=100.0, name="dome")
els = [bowl, dome]
print(f"scene: {sum(e.num_triangles for e in els)} triangles")

src = CollimatedSource(center=(0, 0, 5.0), direction=(0, 0, -1),
                       diameter=3.5, power=1.0, ray_count=BATCH)

tr = Tracer(TraceConfig(trace_iterations=4))
res = tr.trace_batched(src, total_rays=TOTAL_RAYS, batch_size=BATCH,
                       elements=els, checkpoint_path=CKPT)

print(f"ledger: {res.ledger}")
print(f"histogram total: {res.hist.sum():.6f}")
print(f"{res.rays_traced / max(res.wall_time, 1e-9):.3g} ray-bounces/s, "
      f"{res.tests_per_second:.3g} tests/s over {res.wall_time:.1f}s")
