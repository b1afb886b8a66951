"""Run the tracer's main path once on one NVIDIA GPU, at real sizes, and
check what comes out.

    python chip_smoke.py           # phases 1-4 on one card
    python chip_smoke.py --multi   # phase 5 alone: the sharded paths on 4 cards

Phases (BASELINE.json configs; scenes as in benchmarks/baseline_configs.py):
  1. the intersect kernel against the jnp reference on the config-4 scene
     (~138k triangles) with 262,144 random and collimated rays; cull on
     against cull off; a 4096-ray subsample against the float64 oracle;
  2. the reference-compatible entry point, CL_Tracer().iterative_tracer, on
     config 1 (100k rays, 8 iterations, host mode) with oracle parity;
  3. config 2 (1M rays, device mode, 128^2 focal image) and config 3 (200k
     rays with splitting at 4x capacity);
  4. config 4 batched: 16M rays in 4M-ray batches, 4 bounces, auto-cull;
  5. (--multi) mode='multichip' on a 4-card mesh (config 1, 1M rays) and
     mode='mesh2d' on a 2x2 mesh (config-4 scene), each against the same
     trace on one card.

Every check is an assertion: a failing phase ends the process with a
non-zero exit. Without a GPU it exits non-zero at once. The last line of
standard output is one JSON object with the device JAX reports.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
LEDGER_TOL = 1e-5
KERNEL_RAYS = 262_144
ORACLE_RAYS = 4096
CONFIG1_RAYS = 100_000
CONFIG2_RAYS = 1_000_000
CONFIG3_RAYS = 200_000
CONFIG4_BATCH = 4_000_000
CONFIG4_TOTAL = 16_000_000
MULTI_RAYS = 1_000_000


def log(msg):
    print(msg, flush=True)


def ledger_err(res):
    led = res.ledger
    acc = led["measured"] + led["absorbed"] + led["escaped"] + led["culled"]
    return abs(led["emitted"] - acc - res.final_live_power) / led["emitted"]


def timed(fn):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def config1_elements():
    import lightpycl_tpu as L

    oe = L.optical_elements(n_segments=128, n_radial=32)
    return [oe.parabolic_mirror(focus=0.5, diameter=2.0, reflectivity=0.98),
            oe.hemisphere(radius=50.0, name="dome")]


def config1_source(n, seed=1):
    from lightpycl_tpu.sources import light_source

    return light_source(center=(0, 0, 0.5), direction=(0, 0, -1),
                        directivity=lambda az, pol: np.cos(pol),
                        power=1.0, ray_count=n, seed=seed)


def config4(n):
    import lightpycl_tpu as L
    from lightpycl_tpu.sources import CollimatedSource

    oe4 = L.optical_elements(n_segments=360, n_radial=180)
    bowl = oe4.parabolic_mirror(focus=1.0, diameter=4.0, reflectivity=0.95)
    dome = L.optical_elements(128, 32).hemisphere(radius=100.0, name="dome")
    src = CollimatedSource(center=(0, 0, 5.0), direction=(0, 0, -1),
                           diameter=3.5, power=1.0, ray_count=n)
    return [bowl, dome], src


def phase1_kernel():
    import jax
    import jax.numpy as jnp

    import lightpycl_tpu as L
    from lightpycl_tpu.ops.intersect_gpu import intersect_gpu
    from lightpycl_tpu.tracer.config import TraceConfig
    from lightpycl_tpu.tracer.oracle import _mt_nearest_hit
    from lightpycl_tpu.tracer.rays import RayBatch
    from lightpycl_tpu.tracer.step import intersect_jnp, reorder_rays

    n = KERNEL_RAYS
    els, src = config4(n)
    scene, _ = L.build_scene(els, spatial_sort=True)
    log(f"phase 1: {n} rays x {scene.num_triangles_padded} triangles")
    cfg = TraceConfig()
    rng = np.random.default_rng(0)
    o_r = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    o_r[:, 2] = rng.uniform(0.0, 3.0, n)
    d_r = rng.normal(size=(n, 3))
    d_r = (d_r / np.linalg.norm(d_r, axis=1, keepdims=True)).astype(np.float32)
    o_c, d_c, p_c = src.rays_on_device(jax.random.key(4), n)
    collimated = reorder_rays(scene, RayBatch.from_arrays(o_c, d_c, p_c))
    sets = {"random": (jnp.asarray(o_r), jnp.asarray(d_r)),
            "collimated": (collimated.o, collimated.d)}
    for name, (o, d) in sets.items():
        timed(lambda: intersect_gpu(scene, o, d, cfg, cull=False))
        (t_k, i_k), s_k = timed(lambda: intersect_gpu(scene, o, d, cfg,
                                                      cull=False))
        timed(lambda: intersect_gpu(scene, o, d, cfg, cull=True))
        (t_c, i_c), s_c = timed(lambda: intersect_gpu(scene, o, d, cfg,
                                                      cull=True))
        timed(lambda: intersect_jnp(scene, o, d, cfg))
        (t_j, i_j), s_j = timed(lambda: intersect_jnp(scene, o, d, cfg))
        t_k, i_k, t_c, i_c, t_j, i_j = map(np.asarray,
                                           (t_k, i_k, t_c, i_c, t_j, i_j))
        agree = float((i_k == i_j).mean())
        both = (i_k == i_j) & (i_j >= 0)
        t_rel = np.abs(t_k[both] - t_j[both]) / np.abs(t_j[both])
        t_ok = float((t_rel <= 1e-5).mean()) if t_rel.size else 1.0
        log(f"  {name}: kernel {s_k:.4f} s, kernel+cull {s_c:.4f} s, "
            f"jnp {s_j:.4f} s; hits {int((i_j >= 0).sum())}; index "
            f"agreement {agree:.6f}; t within 1e-5 rel on {t_ok:.6f} of "
            f"agreeing hits (max rel {float(t_rel.max(initial=0.0)):.3e})")
        # FMA contraction, summation order and division differ between
        # Triton's and XLA's code: a hit within eps_bary of an edge can
        # flip by an ulp, and for the far dome (radius 100) OW sums terms
        # ~100x larger than itself, so its last bits move t by up to ~1e-3
        # relative in either implementation (the f64 check below bounds
        # the kernel's own error)
        assert agree >= 0.9999, f"kernel vs jnp index agreement {agree}"
        assert t_ok >= 0.999, f"kernel vs jnp t within 1e-5 on {t_ok}"
        assert t_rel.max(initial=0.0) <= 1e-3, "kernel vs jnp t mismatch"
        assert np.array_equal(i_k, i_c), "cull changed hit indices"
        assert np.array_equal(t_k[i_k >= 0], t_c[i_k >= 0]), "cull changed t"

    # the oracle indexes the unsorted soup: compare on an unsorted scene
    flat, _ = L.build_scene(els)
    o, d = (a[:ORACLE_RAYS] for a in sets["random"])
    t_k, i_k = map(np.asarray, intersect_gpu(flat, o, d, cfg))
    t_j, _ = map(np.asarray, intersect_jnp(flat, o, d, cfg))
    tv = np.concatenate([e.triangle_vertices() for e in els])
    t_o, i_o = _mt_nearest_hit(np.asarray(o, np.float64),
                               np.asarray(d, np.float64), tv[:, 0],
                               tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0],
                               cfg.eps, cfg.eps_bary, cfg.max_ray_len)
    agree = float((i_k == i_o).mean())
    hit = (i_k == i_o) & (i_o >= 0)
    err_k = np.abs(t_k[hit] - t_o[hit]) / t_o[hit]
    err_j = np.abs(t_j[hit] - t_o[hit]) / t_o[hit]
    log(f"  f64 oracle: index agreement {agree:.5f} on {ORACLE_RAYS} rays; "
        f"t rel error mean/max kernel {err_k.mean():.3e}/{err_k.max():.3e}, "
        f"jnp {err_j.mean():.3e}/{err_j.max():.3e}")
    assert agree >= 0.995, f"kernel vs f64 oracle agreement {agree}"
    assert err_k.mean() <= 2 * err_j.mean() + 1e-6, "kernel t less accurate"


def phase2_compat():
    import lightpycl_tpu as L
    from lightpycl_tpu.compat import CL_Tracer
    from lightpycl_tpu.tracer.engine import Tracer
    from lightpycl_tpu.tracer.oracle import trace_oracle

    els = config1_elements()
    ls = config1_source(CONFIG1_RAYS)
    tracer = CL_Tracer()
    t0 = time.perf_counter()
    res = tracer.iterative_tracer(ls, els, trace_iterations=8,
                                  max_ray_len=1e3, ior_env=1.0)
    wall = time.perf_counter() - t0
    err = ledger_err(res)
    log(f"phase 2: config 1 iterative_tracer, {CONFIG1_RAYS} rays: detected "
        f"{res.ledger['measured']:.6f}, ledger error {err:.2e}, "
        f"{wall:.3f} s (compile included)")
    assert err <= LEDGER_TOL, f"config 1 ledger {err}"
    o, d, p = ls.sample()
    k = ORACLE_RAYS
    p_k = p[:k] * (p.sum() / p[:k].sum())
    ora = trace_oracle(els, o[:k], d[:k], p_k, trace_iterations=8)
    sub = Tracer().trace(None, els, trace_iterations=8,
                         rays=L.RayBatch.from_arrays(o[:k], d[:k], p_k))
    parity = abs(sub.ledger["measured"] - ora["measured"]) / ora["measured"]
    log(f"  f64 oracle parity on {k} rays: {parity:.2e}")
    assert parity <= 1e-3, f"config 1 oracle parity {parity}"


def phase3_configs():
    import lightpycl_tpu as L
    from lightpycl_tpu.sources import CollimatedSource
    from lightpycl_tpu.tracer.engine import Tracer

    oe2 = L.optical_elements(n_segments=128, n_radial=48)
    lens = oe2.plano_convex_lens(r=0.5, aperture=0.6, thickness=0.1, ior=1.5)
    det = oe2.disc(radius=0.5, center=(0, 0, 1.1), material="measure")
    enc = oe2.sphere(radius=10.0, material="terminator")
    src = CollimatedSource(center=(0, 0, -0.5), direction=(0, 0, 1),
                           diameter=0.4, power=1.0, ray_count=CONFIG2_RAYS,
                           seed=2)
    kw = dict(image_bins=128, image_center=(0, 0, 1.1), image_halfwidth=0.05)
    tr = Tracer()
    t0 = time.perf_counter()
    tr.trace(src, [lens, det, enc], trace_iterations=6, mode="device", **kw)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = tr.trace(src, [lens, det, enc], trace_iterations=6, mode="device",
                   **kw)
    wall = time.perf_counter() - t0
    peak = tuple(int(i) for i in np.unravel_index(res.image.argmax(),
                                                  res.image.shape))
    err = ledger_err(res)
    log(f"phase 3: config 2, {CONFIG2_RAYS} rays: detected "
        f"{res.ledger['measured']:.6f}, image peak bin {peak}, ledger error "
        f"{err:.2e}, first {first:.3f} s, warm {wall:.3f} s")
    assert err <= LEDGER_TOL, f"config 2 ledger {err}"
    assert all(i in (63, 64) for i in peak), f"focal peak off centre {peak}"

    n3 = CONFIG3_RAYS
    l1 = oe2.biconvex_lens(1.0, 0.8, 0.2, ior=1.5)
    l2 = oe2.biconvex_lens(1.5, 0.8, 0.15, ior=1.7).translate((0, 0, 0.5))
    enc3 = oe2.sphere(radius=6.0, material="measure", name="enclosure")
    src3 = CollimatedSource(center=(0, 0, -0.5), direction=(0, 0, 1),
                            diameter=0.5, power=1.0, ray_count=n3, seed=3)
    tr3 = Tracer()
    t0 = time.perf_counter()
    res3 = tr3.trace(src3, [l1, l2, enc3], trace_iterations=5, mode="device",
                     capacity=4 * n3)
    wall = time.perf_counter() - t0
    err = ledger_err(res3)
    log(f"  config 3, {n3} rays, capacity {4 * n3}: detected "
        f"{res3.ledger['measured']:.6f}, culled {res3.ledger['culled']:.3e},"
        f" ledger error {err:.2e}, {wall:.3f} s (compile included)")
    assert err <= LEDGER_TOL, f"config 3 ledger {err}"


def phase4_batched():
    import jax

    from lightpycl_tpu.tracer.config import TraceConfig
    from lightpycl_tpu.tracer.engine import Tracer

    batch, total = CONFIG4_BATCH, CONFIG4_TOTAL
    els, src = config4(batch)
    tr = Tracer(TraceConfig(trace_iterations=4))
    t0 = time.perf_counter()
    tr.trace_batched(src, total_rays=batch, batch_size=batch, elements=els)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = tr.trace_batched(src, total_rays=total, batch_size=batch,
                           elements=els)
    wall = time.perf_counter() - t0
    err = ledger_err(res)
    stats = jax.devices()[0].memory_stats() or {}
    log(f"phase 4: config 4 batched, {total} rays x {tr.num_triangles} "
        f"triangles, 4 bounces: detected {res.ledger['measured']:.6f}, "
        f"ledger error {err:.2e}; first (compiling) batch {first:.3f} s; "
        f"warm {wall:.3f} s = {total / wall:.4g} rays/s; peak_bytes_in_use "
        f"{stats.get('peak_bytes_in_use')}")
    assert err <= LEDGER_TOL, f"config 4 ledger {err}"


def phase5_multi():
    import jax

    from lightpycl_tpu.parallel.mesh2d import make_mesh2d
    from lightpycl_tpu.parallel.sharding import make_ray_mesh
    from lightpycl_tpu.tracer.config import TraceConfig
    from lightpycl_tpu.tracer.engine import Tracer

    n_dev = len(jax.devices())
    assert n_dev == 4, f"--multi needs 4 cards, found {n_dev}"
    els = config1_elements()
    ls = config1_source(MULTI_RAYS)
    Tracer().trace(ls, els, trace_iterations=8, mode="device")
    one = Tracer().trace(ls, els, trace_iterations=8, mode="device")
    Tracer().trace(ls, els, trace_iterations=8, mode="multichip",
                   mesh=make_ray_mesh(4))
    multi = Tracer().trace(ls, els, trace_iterations=8, mode="multichip",
                           mesh=make_ray_mesh(4))
    # atomics sum in a run-dependent order: equal to f32 reassociation
    rel = abs(multi.ledger["measured"] - one.ledger["measured"]) \
        / one.ledger["measured"]
    log(f"phase 5: multichip x4, config 1, {MULTI_RAYS} rays: detected "
        f"{multi.ledger['measured']:.7f} vs one card "
        f"{one.ledger['measured']:.7f} (rel {rel:.2e}); ledger errors "
        f"{ledger_err(multi):.2e} / {ledger_err(one):.2e}; warm "
        f"{multi.wall_time:.3f} s vs one card {one.wall_time:.3f} s")
    assert rel <= 1e-5, f"multichip detected power off by {rel}"
    assert ledger_err(multi) <= LEDGER_TOL and ledger_err(one) <= LEDGER_TOL

    els4, src4 = config4(MULTI_RAYS)
    cfg = TraceConfig(trace_iterations=4)
    Tracer(cfg).trace(src4, els4, mode="device")
    one = Tracer(cfg).trace(src4, els4, mode="device")
    tr = Tracer(cfg)
    tr.trace(src4, els4, mode="mesh2d", mesh=make_mesh2d(2, 2))
    m2 = tr.trace(src4, els4, mode="mesh2d", mesh=make_mesh2d(2, 2))
    rel = abs(m2.ledger["measured"] - one.ledger["measured"]) \
        / one.ledger["measured"]
    log(f"  mesh2d 2 tris x 2 rays, config-4 scene, {MULTI_RAYS} rays: "
            f"detected "
        f"{m2.ledger['measured']:.7f} vs one card "
        f"{one.ledger['measured']:.7f} (rel {rel:.2e}); ledger errors "
        f"{ledger_err(m2):.2e} / {ledger_err(one):.2e}; warm "
        f"{m2.wall_time:.3f} s vs one card {one.wall_time:.3f} s")
    assert rel <= 1e-5, f"mesh2d detected power off by {rel}"
    assert ledger_err(m2) <= LEDGER_TOL and ledger_err(one) <= LEDGER_TOL


def main():
    multi = "--multi" in sys.argv[1:]
    sys.path.insert(0, ROOT)
    from lightpycl_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke.py needs a GPU; JAX found {dev.platform}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    log(card)
    log(f"device_kind: {dev.device_kind}")
    log(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')}")
    log(f"jax {jax.__version__}")
    phases = ([phase5_multi] if multi else
              [phase1_kernel, phase2_compat, phase3_configs, phase4_batched])
    for phase in phases:
        t0 = time.perf_counter()
        phase()
        log(f"  {phase.__name__} done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
