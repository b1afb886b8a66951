"""Intersect timings on the GPU at the config-4 shape (BASELINE config 4:
the 360-segment bowl plus the dome, ~138k triangles, 4M collimated rays).

    python benchmarks/intersect_bench.py sweep   # kernel launch-shape sweep
    python benchmarks/intersect_bench.py cull    # cull-tile sweep
    python benchmarks/intersect_bench.py e2e     # kernel vs jnp reference,
                                                 # end to end (trace_batched)

Every result is one JSON line on stdout, with the device it ran on. The
script refuses to run without a GPU: a CPU number is not a device number.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def emit(**kw):
    print(json.dumps(kw), flush=True)


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def config4():
    import lightpycl_tpu as L
    from lightpycl_tpu.sources import CollimatedSource

    oe4 = L.optical_elements(n_segments=360, n_radial=180)
    bowl = oe4.parabolic_mirror(focus=1.0, diameter=4.0, reflectivity=0.95)
    dome = L.optical_elements(128, 32).hemisphere(radius=100.0, name="dome")
    src = CollimatedSource(center=(0, 0, 5.0), direction=(0, 0, -1),
                           diameter=3.5, power=1.0, ray_count=4_000_000)
    return [bowl, dome], src


def best_of(fn, reps):
    import jax

    jax.block_until_ready(fn())  # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return min(times), times


def first_bounce(n_rays):
    """The config-4 scene (spatially sorted) and n_rays source rays."""
    import jax

    import lightpycl_tpu as L

    els, src = config4()
    scene, _ = L.build_scene(els, spatial_sort=True)
    o, d, p = src.rays_on_device(jax.random.key(0), n_rays)
    return scene, o, d, p


def sweep(n_rays=4_000_000):
    """Brute-force kernel time per launch shape at the config-4 shape; the
    agreement of the first shape with intersect_jnp on 262,144 rays."""
    from lightpycl_tpu.ops import intersect_gpu as ig
    from lightpycl_tpu.tracer.config import TraceConfig
    from lightpycl_tpu.tracer.step import intersect_jnp

    scene, o, d, _ = first_bounce(n_rays)
    cfg = TraceConfig()
    T = scene.num_triangles_padded
    n_chk = 262_144
    t_k, i_k = map(np.asarray, ig.intersect_gpu(scene, o[:n_chk], d[:n_chk],
                                                cfg, cull=False))
    t_j, i_j = map(np.asarray, intersect_jnp(scene, o[:n_chk], d[:n_chk], cfg))
    same = i_k == i_j
    both = same & (i_k >= 0)
    emit(bench="kernel_vs_jnp", rays=n_chk, index_agreement=float(same.mean()),
         hits=int((i_j >= 0).sum()),
         t_max_rel=float(np.max(np.abs(t_k[both] - t_j[both])
                                / np.abs(t_j[both]), initial=0.0)))
    ref = None
    shapes = [(64, 32, 4, 2), (32, 32, 4, 2), (128, 32, 4, 2),
              (64, 64, 4, 2), (32, 64, 4, 2), (64, 16, 4, 2),
              (128, 32, 8, 2), (128, 64, 8, 2), (64, 32, 2, 2),
              (64, 32, 4, 1), (64, 32, 4, 3)]
    best = None
    for R, K, W, S in shapes:
        def run():
            return ig.intersect_gpu(scene, o, d, cfg, cull=False,
                                    ray_block=R, tri_tile=K, num_warps=W,
                                    num_stages=S)
        try:
            t, ts = best_of(run, 2)
        except Exception as e:  # a shape the compiler refuses is a result
            emit(bench="sweep", R=R, K=K, num_warps=W, num_stages=S,
                 error=repr(e)[:300])
            continue
        _, idx = run()
        idx = np.asarray(idx)
        if ref is None:
            ref = idx
        agree = float((idx == ref).mean())
        emit(bench="sweep", R=R, K=K, num_warps=W, num_stages=S, rays=n_rays,
             tris=T, kernel_s=t, reps_s=ts, pairs_per_s=n_rays * T / t,
             index_agreement_vs_first=agree)
        if best is None or t < best[0]:
            best = (t, R, K, W, S)
    _, R, K, W, S = best
    emit(bench="sweep_best", R=R, K=K, num_warps=W, num_stages=S)
    return best


def sweep_cull(n_rays=4_000_000):
    """Kernel time with cull per cull tile, on Morton-sorted first-bounce
    rays (the mask computation included)."""
    from lightpycl_tpu.ops import intersect_gpu as ig
    from lightpycl_tpu.tracer.config import TraceConfig
    from lightpycl_tpu.tracer.rays import RayBatch
    from lightpycl_tpu.tracer.step import reorder_rays

    scene, o, d, p = first_bounce(n_rays)
    cfg = TraceConfig()
    rays = reorder_rays(scene, RayBatch.from_arrays(o, d, p))
    _, i_ref = ig.intersect_gpu(scene, rays.o, rays.d, cfg, cull=False)
    for CT in (64, 128, 256, 512, 1024):
        def run_cull():
            return ig.intersect_gpu(scene, rays.o, rays.d, cfg, cull=True,
                                    alive=rays.alive, cull_tile=CT)
        t, ts = best_of(run_cull, 2)
        same = bool((np.asarray(run_cull()[1]) == np.asarray(i_ref)).all())
        emit(bench="sweep_cull", cull_tile=CT, kernel_s=t, reps_s=ts,
             same_as_brute=same)


def e2e(shape=None, n_rays=4_000_000):
    """The kernel, brute and with cull, against intersect_jnp (the plain
    reference XLA compiles), each through Tracer.trace_batched: 4 bounces,
    one 4M-ray batch."""
    from lightpycl_tpu.ops import intersect_gpu as ig
    from lightpycl_tpu.tracer.config import TraceConfig
    from lightpycl_tpu.tracer.engine import Tracer

    if shape is not None:
        ig.RAY_BLOCK, ig.TRI_TILE, ig.NUM_WARPS, ig.NUM_STAGES = shape
    els, src = config4()
    runs = [("kernel_brute", dict(cull=False)),
            ("kernel_cull", dict(cull=None)),
            ("jnp_reference", dict(cull=False, backend="jnp"))]
    for name, kw in runs:
        tr = Tracer(TraceConfig(trace_iterations=4, **kw))
        t0 = time.perf_counter()
        tr.trace_batched(src, total_rays=n_rays, batch_size=n_rays,
                         elements=els)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = tr.trace_batched(src, total_rays=n_rays, batch_size=n_rays,
                               elements=els)
        wall = time.perf_counter() - t0
        led = res.ledger
        acc = sum(led[k] for k in ("measured", "absorbed", "escaped",
                                   "culled"))
        emit(bench="e2e", variant=name, rays=n_rays, iterations=4,
             bounces_run=res.iterations_run, first_batch_s=first,
             warm_s=wall, rays_per_s=n_rays / wall,
             measured=led["measured"],
             ledger_err=abs(acc - led["emitted"]) / led["emitted"])


def main():
    from lightpycl_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU, found {dev.platform}")
    emit(card=card(), device_kind=dev.device_kind, jax=jax.__version__,
         xla_flags=os.environ.get("XLA_FLAGS", ""))
    what = sys.argv[1:] or ["sweep", "cull", "e2e"]
    shape = None
    if "sweep" in what:
        shape = sweep()[1:]
    if "cull" in what:
        sweep_cull()
    if "e2e" in what:
        e2e(shape)


if __name__ == "__main__":
    main()
