"""GRIN multi-substep benchmark: curved steps through a SELFOC rod inside
a LARGE scene. grin_substeps=k replaces k-1 of every k full-scene
intersects with a re-intersect against only the rod's own Tg triangles,
so the speedup approaches the fraction of iterations that were mid-medium
steps. Prints one JSON line per configuration.

Usage: python benchmarks/grin_substep_bench.py [RAY_COUNT] [DOME_SEGS]
(JAX_PLATFORMS=cpu for CPU smoke runs; on the GPU the full intersect is
the Pallas kernel and the win is the same ratio at far larger scales.)
"""

import json
import sys
import time

import numpy as np

import lightpycl_tpu as L
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu.tracer.config import TraceConfig
from lightpycl_tpu.tracer.engine import Tracer

RAY_COUNT = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
DOME_SEGS = int(sys.argv[2]) if len(sys.argv) > 2 else 96

N0, A = 1.6, 4.0
PITCH = 2.0 * np.pi / np.sqrt(A)
LENGTH = PITCH  # a full pitch: ~50 curved steps at the default h

oe = L.optical_elements(n_segments=DOME_SEGS, n_radial=DOME_SEGS // 3)
rod = oe.cube((1.2, 1.2, LENGTH), center=(0, 0, 1.0 + LENGTH / 2),
              material="refractive", ior=N0, grin_a=A, axis=(0, 0, 1),
              grin_center=(0, 0, 1.0))
dome = oe.sphere(radius=25.0, material="measure", name="world")
src = CollimatedSource(center=(0, 0, 0), direction=(0, 0, 1), diameter=0.4,
                       power=1.0, ray_count=RAY_COUNT, seed=3)

results = {}
for substeps, iters in ((1, 64), (4, 20), (8, 12)):
    tr = Tracer(TraceConfig(grin_substeps=substeps))
    # warm compile
    tr.trace(src, [rod, dome], trace_iterations=iters,
             capacity=2 * RAY_COUNT)
    t0 = time.perf_counter()
    res = tr.trace(src, [rod, dome], trace_iterations=iters,
                   capacity=2 * RAY_COUNT)
    wall = time.perf_counter() - t0
    results[substeps] = (wall, res)
    print(json.dumps({
        "bench": "grin_substeps",
        "substeps": substeps,
        "iterations": iters,
        "rays": RAY_COUNT,
        "scene_triangles": tr.num_triangles,
        "wall_s": round(wall, 4),
        "measured": round(res.ledger["measured"], 6),
        "conservation_err": res.power_conservation_error(),
        "speedup_vs_substeps1": round(results[1][0] / wall, 3),
    }))
