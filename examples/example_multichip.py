"""BASELINE config 5: rays sharded over 8 devices, replicated mesh, psum
detector histogram, linear scaling check.

Uses the same `Tracer` API as every single-device example — just
mode="multichip" (the engine shards the batch, traces SPMD, and psums the
detector state back into a normal TraceResult).

On a single-chip box, simulate the mesh with 8 virtual CPU devices:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    JAX_PLATFORMS=cpu python examples/example_multichip.py
"""

import os
import time

import jax
import numpy as np

import lightpycl_tpu as L
from lightpycl_tpu.parallel.sharding import make_ray_mesh
from lightpycl_tpu.sources import light_source
from lightpycl_tpu.tracer.config import TraceConfig
from lightpycl_tpu.tracer.engine import Tracer
from lightpycl_tpu.utils import setup_logging

setup_logging()

RAY_COUNT = int(os.environ.get("RAY_COUNT", 1 << 17))
ITERS = 6

oe = L.optical_elements(n_segments=96, n_radial=24)
els = [oe.parabolic_mirror(0.5, 2.0, reflectivity=0.95),
       oe.hemisphere(20.0, name="dome")]

ls = light_source(center=(0, 0, 0.5), direction=(0, 0, -1),
                  power=1.0, ray_count=RAY_COUNT, seed=1)

tracer = Tracer(TraceConfig()).set_elements(els)
n_avail = len(jax.devices())
for n_dev in [x for x in (1, 2, 4, 8) if x <= n_avail]:
    mesh = make_ray_mesh(n_dev)
    # warm up / compile
    tracer.trace(ls, trace_iterations=ITERS, mode="multichip", mesh=mesh)
    t0 = time.perf_counter()
    res = tracer.trace(ls, trace_iterations=ITERS, mode="multichip", mesh=mesh)
    dt = time.perf_counter() - t0
    print(f"{n_dev} device(s): {dt * 1e3:8.1f} ms  "
          f"measured={res.ledger['measured']:.6f}  "
          f"hist_total={float(np.asarray(res.hist).sum()):.6f}")
print("detector histogram and ledger are psum'd across the mesh; "
      "measured power must be identical at every device count.")
