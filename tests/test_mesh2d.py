"""2-D (tris x rays) mesh decomposition: must reproduce the single-device
trace on 2x4 and 4x2 virtual meshes."""

import jax
import numpy as np
import pytest

import lightpycl_tpu as L
from lightpycl_tpu.parallel.mesh2d import make_mesh2d, place, trace_mesh2d
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu.tracer.config import TraceConfig
from lightpycl_tpu.tracer.engine import Tracer
from lightpycl_tpu.tracer.rays import RayBatch

oe = L.optical_elements(n_segments=24, n_radial=8)


def setup_case():
    els = [oe.parabolic_mirror(0.5, 2.0, reflectivity=0.9),
           oe.hemisphere(10.0, name="dome"),
           oe.biconvex_lens(1.0, 0.6, 0.1, ior=1.5, center=(0, 0, 1.0))]
    src = CollimatedSource(center=(0, 0, 3), direction=(0, 0, -1),
                           diameter=1.5, ray_count=1024, power=1.0, seed=3)
    o, d, p = src.sample()
    return els, src, RayBatch.from_arrays(o, d, p)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (8, 1), (1, 8)])
def test_mesh2d_matches_single_device(shape):
    els, src, rays = setup_case()
    cfg = TraceConfig(hist_azimuth_bins=16, hist_polar_bins=8)

    res1 = Tracer(cfg).trace(src, els, trace_iterations=5, mode="device",
                             rays=rays, capacity=1024)

    scene, _ = L.build_scene(els)
    assert scene.num_triangles_padded % shape[0] == 0
    mesh = make_mesh2d(*shape)
    els2, src2, rays2 = setup_case()
    scene_sh, rays_sh = place(scene, rays2, mesh)
    rays_out, det, led = trace_mesh2d(scene_sh, rays_sh, cfg, 5, mesh)

    assert float(led.emitted) == pytest.approx(res1.ledger["emitted"], rel=1e-6)
    for k in ("measured", "absorbed", "escaped", "culled"):
        assert float(getattr(led, k)) == pytest.approx(
            res1.ledger[k], rel=1e-4, abs=1e-6), k
    assert np.allclose(np.asarray(det.hist), res1.hist, atol=1e-5)
    # conservation including live power
    live = float(np.asarray((rays_out.power * rays_out.alive).sum()))
    acc = float(led.measured + led.absorbed + led.escaped + led.culled)
    assert acc + live == pytest.approx(1.0, rel=1e-5)


def test_mesh2d_roulette_conserves():
    """Roulette draws must be identical across the TRI axis (shade/compact
    run replicated there); conservation stays exact on a 2x4 mesh."""
    els, src, rays = setup_case()
    cfg = TraceConfig(roulette_threshold=5e-3)
    scene, _ = L.build_scene(els)
    mesh = make_mesh2d(2, 4)
    scene_sh, rays_sh = place(scene, rays, mesh)
    rays_out, det, led = trace_mesh2d(scene_sh, rays_sh, cfg, 6, mesh,
                                      key=jax.random.key(11))
    live = float(np.asarray((rays_out.power * rays_out.alive).sum()))
    acc = float(led.measured + led.absorbed + led.escaped + led.culled)
    assert acc + live == pytest.approx(1.0, rel=1e-5)
    assert float(led.measured) > 0.5


def test_mesh2d_roulette_requires_key():
    els, src, rays = setup_case()
    cfg = TraceConfig(roulette_threshold=5e-3)
    scene, _ = L.build_scene(els)
    mesh = make_mesh2d(2, 4)
    scene_sh, rays_sh = place(scene, rays, mesh)
    with pytest.raises(ValueError, match="PRNG key"):
        trace_mesh2d(scene_sh, rays_sh, cfg, 4, mesh)


def test_mesh2d_many_detectors():
    """n_detectors sizes the per-detector accumulator (was hard-coded 8)."""
    from lightpycl_tpu.materials import Material

    n_det = 10
    els = [
        oe.rectangle(1.0, 4.0, center=(x - (n_det - 1) / 2.0, 0, 0),
                     material=Material.MEASURE, name=f"panel{x}")
        for x in range(n_det)
    ]
    els.append(oe.rectangle(40.0, 40.0, center=(0, 0, -1.0),
                            material=Material.TERMINATOR))
    src = CollimatedSource(center=(0, 0, 3), direction=(0, 0, -1),
                           diameter=9.0, ray_count=4096, power=1.0, seed=6)
    cfg = TraceConfig()
    res1 = Tracer(cfg).trace(src, els, trace_iterations=2, mode="device")

    scene, det_names = L.build_scene(els)
    o, d, p = src.sample()
    mesh = make_mesh2d(2, 4)
    scene_sh, rays_sh = place(scene, RayBatch.from_arrays(o, d, p), mesh)
    _, det, led = trace_mesh2d(scene_sh, rays_sh, cfg, 2, mesh,
                               n_detectors=len(det_names))
    assert np.asarray(det.per_detector).shape == (n_det,)
    assert (res1.per_detector > 0).all()
    np.testing.assert_allclose(np.asarray(det.per_detector),
                               res1.per_detector, atol=1e-5)


def test_engine_mesh2d_mode():
    """Tracer.trace(mode='mesh2d', mesh=...) returns the same TraceResult
    as the single-device run."""
    els, src, rays = setup_case()
    cfg = TraceConfig(hist_azimuth_bins=16, hist_polar_bins=8)
    tr = Tracer(cfg)
    res1 = tr.trace(src, els, trace_iterations=5, mode="device")
    res2 = tr.trace(src, els, trace_iterations=5, mode="mesh2d",
                    mesh=make_mesh2d(2, 4))
    assert res2.ledger["measured"] == pytest.approx(res1.ledger["measured"],
                                                    rel=1e-4)
    np.testing.assert_allclose(res2.hist, res1.hist, atol=1e-5)
    assert res2.per_detector.shape == res1.per_detector.shape
    assert res2.power_conservation_error() < 1e-5


def test_engine_mesh2d_requires_mesh():
    els, src, rays = setup_case()
    with pytest.raises(ValueError, match="mesh2d"):
        Tracer(TraceConfig()).trace(src, els, trace_iterations=2,
                                    mode="mesh2d")


def test_mesh2d_dual_order_grating_matches_single_device():
    """Gratings under the 2-D decomposition: the winner-contributes psum
    must carry grating_mlp AND grating_g0 so the dual-order split
    reproduces the single-device trace exactly."""
    gr = oe.rectangle(4.0, 4.0, material="grating", axis=(1, 0, 0),
                      grating_period=1.2, grating_order=1,
                      reflectivity=0.9)
    gr.order0_fraction = 0.25
    els = [gr, oe.sphere(radius=5.0, material="measure", name="dome")]
    n = 512
    o = np.tile([0.0, 0.0, 2.0], (n, 1))
    d = np.tile([0.0, 0.0, -1.0], (n, 1))
    p = np.full(n, 1.0 / n)
    cfg = TraceConfig(hist_azimuth_bins=16, hist_polar_bins=8)

    # capacity 4n (the standard split headroom): place() round-robin
    # interleaves the front-packed live rays across the 4-way RAY axis, so
    # each shard holds n/4 live rays + its share of the headroom and the
    # dual-order split never overflows per-shard compaction.
    res1 = Tracer(cfg).trace(
        None, els, trace_iterations=3, mode="device",
        rays=RayBatch.from_arrays(o, d, p, wavelengths=0.6,
                                  capacity=4 * n))

    scene, _ = L.build_scene(els)
    mesh = make_mesh2d(2, 4)
    rays2 = RayBatch.from_arrays(o, d, p, wavelengths=0.6, capacity=4 * n)
    scene_sh, rays_sh = place(scene, rays2, mesh)
    _, det, led = trace_mesh2d(scene_sh, rays_sh, cfg, 3, mesh)

    for k in ("measured", "absorbed", "escaped", "culled"):
        assert float(getattr(led, k)) == pytest.approx(
            res1.ledger[k], rel=1e-5, abs=1e-6), k
    assert np.allclose(np.asarray(det.hist), res1.hist, atol=1e-5)


def test_mesh2d_cull_exact_parity():
    """The cull accelerator reaches the 2-D mesh
    path. Each triangle shard is a contiguous slice of the spatially-
    sorted tile stream, so per-shard masks are conservative locally; the
    Morton resort uses a pmin/pmax-global quantization box so every TRI
    rank permutes identically. Contract: same ledger/histogram as the
    cull-off mesh2d trace (within f32 reduction-order jitter)."""
    from lightpycl_tpu.parallel.mesh2d import make_mesh2d

    els, src, _ = setup_case()
    mesh = make_mesh2d(2, 4)
    r_off = Tracer(TraceConfig()).trace(
        src, els, trace_iterations=5, mode="mesh2d", mesh=mesh,
        capacity=1024, cull=False)
    r_on = Tracer(TraceConfig()).trace(
        src, els, trace_iterations=5, mode="mesh2d", mesh=mesh,
        capacity=1024, cull=True)
    for k in ("measured", "absorbed", "escaped"):
        assert r_on.ledger[k] == pytest.approx(r_off.ledger[k],
                                               rel=2e-5, abs=1e-7), k
    np.testing.assert_allclose(r_on.hist, r_off.hist, atol=1e-5)
    # auto (cull=None) resolves ON for this collimated bundle and
    # matches too — the accelerator is the default on the 2-D path now
    r_auto = Tracer(TraceConfig()).trace(
        src, els, trace_iterations=5, mode="mesh2d", mesh=mesh,
        capacity=1024)
    assert r_auto.ledger["measured"] == pytest.approx(
        r_on.ledger["measured"], rel=2e-5)
