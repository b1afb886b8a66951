"""Conservative block x tile culling: results must be IDENTICAL to brute
force (the mask may only skip provably-unreachable cells)."""

import jax.numpy as jnp
import numpy as np
import pytest

import lightpycl_tpu as L
from lightpycl_tpu.ops.intersect_gpu import intersect_gpu
from lightpycl_tpu.tracer.config import TraceConfig
from lightpycl_tpu.tracer.scene import build_scene

oe = L.optical_elements(n_segments=24, n_radial=8)
CFG = TraceConfig()


def scenes():
    return [
        oe.parabolic_mirror(0.5, 2.0),
        oe.sphere(5.0, material="measure"),
        oe.cube(0.4, center=(0.6, 0.1, 0.8), material="refractive", ior=1.5),
    ]


def check(o, d):
    scene, _ = build_scene(scenes())
    kw = dict(ray_block=128, tri_tile=256, interpret=True)
    t0, i0 = map(np.asarray, intersect_gpu(scene, o, d, CFG, cull=False, **kw))
    t1, i1 = map(np.asarray, intersect_gpu(scene, o, d, CFG, cull=True, **kw))
    assert (i0 == i1).all()
    both = np.isfinite(t0)
    assert np.array_equal(t0[both], t1[both])


class TestCullExactness:
    def test_random_rays(self, rng):
        o = rng.uniform(-2, 2, (300, 3)).astype(np.float32)
        d = rng.normal(size=(300, 3))
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        check(jnp.asarray(o), jnp.asarray(d))

    def test_collimated_bundle(self, rng):
        # coherent bundle: the case the cull is built for
        o = np.zeros((256, 3), np.float32)
        o[:, 0] = rng.uniform(-0.2, 0.2, 256)
        o[:, 1] = rng.uniform(-0.2, 0.2, 256)
        o[:, 2] = -1.0
        d = np.tile([0, 0, 1.0], (256, 1)).astype(np.float32)
        check(jnp.asarray(o), jnp.asarray(d))

    def test_axis_parallel_rays(self):
        # rays exactly parallel to axes exercise the 'par' interval case
        o = np.array([[0, 0, -1], [0.1, 0, 0], [0, 0.1, 0]], np.float32)
        d = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], np.float32)
        check(jnp.asarray(o), jnp.asarray(d))

    def test_cull_rate_positive_for_coherent(self, rng):
        # the mask actually culls something for a tight bundle
        from lightpycl_tpu.ops.intersect_gpu import _cull_mask, pack_aabbs

        # fine sphere -> tiles are phi-wedges; an off-axis bundle provably
        # misses the wedges on the far side
        fine = L.geometry.primitives.OpticalElements(64, 32)
        scene, _ = build_scene([fine.sphere(5.0, material="measure")])
        lo, hi = pack_aabbs(scene, 256)
        C = 256
        o = np.tile([2.0, 2.0, -10.0], (C, 1)).astype(np.float32)
        d = np.tile([0, 0, 1.0], (C, 1)).astype(np.float32)
        mask = np.asarray(_cull_mask(jnp.asarray(o), jnp.asarray(d),
                                     lo, hi, 128, 1e3))
        assert mask.mean() < 0.8  # far-side wedges provably unreachable


class TestCullTrace:
    def test_trace_with_cull_matches(self):
        from lightpycl_tpu.sources import CollimatedSource
        from lightpycl_tpu.tracer.engine import Tracer

        els = [oe.parabolic_mirror(0.5, 2.0, reflectivity=0.9),
               oe.hemisphere(10.0, name="dome"),
               oe.biconvex_lens(1.0, 0.6, 0.1, ior=1.5, center=(0, 0, 1.0))]
        src = CollimatedSource(center=(0, 0, 3), direction=(0, 0, -1),
                               diameter=1.5, ray_count=1024, power=1.0, seed=3)
        r0 = Tracer().trace(src, els, trace_iterations=5, mode="device")
        r1 = Tracer().trace(src, els, trace_iterations=5, mode="device",
                            cull=True)
        for k in ("measured", "absorbed", "escaped"):
            assert r1.ledger[k] == pytest.approx(r0.ledger[k], rel=1e-4, abs=1e-7)
        assert np.allclose(r1.hist, r0.hist, atol=1e-5)

    def test_morton_order_groups_dead_last(self, rng):
        from lightpycl_tpu.tracer.step import morton_order

        o = jnp.asarray(rng.uniform(0, 1, (64, 3)), jnp.float32)
        alive = jnp.asarray(rng.uniform(size=64) > 0.5)
        order = np.asarray(morton_order(o, alive, jnp.zeros(3), jnp.ones(3)))
        alive_np = np.asarray(alive)[order]
        n_live = alive_np.sum()
        assert alive_np[:n_live].all() and not alive_np[n_live:].any()


class TestCullGen2:
    def test_all_dead_block_culls_everything(self):
        from lightpycl_tpu.ops.intersect_gpu import _cull_mask, pack_aabbs

        scene, _ = build_scene(scenes())
        lo, hi = pack_aabbs(scene, 256)
        C = 256
        o = np.zeros((C, 3), np.float32)
        d = np.tile([0, 0, 1.0], (C, 1)).astype(np.float32)
        alive = jnp.zeros((C,), bool)
        mask = np.asarray(_cull_mask(jnp.asarray(o), jnp.asarray(d),
                                     lo, hi, 128, 1e3, alive=alive))
        assert (mask == 0).all()

    def test_mixed_alive_still_exact(self, rng):
        # half the rays dead with garbage directions: results for the live
        # ones must be identical to brute force
        scene, _ = build_scene(scenes())
        n = 256
        o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3))
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        alive = jnp.asarray(rng.uniform(size=n) > 0.5)
        kw = dict(ray_block=128, tri_tile=256, interpret=True)
        t0, i0 = map(np.asarray, intersect_gpu(
            scene, jnp.asarray(o), jnp.asarray(d), CFG, cull=False, **kw))
        t1, i1 = map(np.asarray, intersect_gpu(
            scene, jnp.asarray(o), jnp.asarray(d), CFG, cull=True,
            alive=alive, **kw))
        live = np.asarray(alive)
        assert (i0[live] == i1[live]).all()

    def test_diverging_bundle_exact(self, rng):
        # point-source-like divergent bundle exercises the cone test
        scene, _ = build_scene(scenes())
        n = 256
        o = np.tile([0.0, 0.0, 0.6], (n, 1)).astype(np.float32)
        z = rng.uniform(0.7, 1.0, n)
        phi = rng.uniform(0, 2 * np.pi, n)
        s = np.sqrt(1 - z**2)
        d = np.stack([s * np.cos(phi), s * np.sin(phi), -z], 1).astype(np.float32)
        check(jnp.asarray(o), jnp.asarray(d))


class TestCullRecordPaths:
    def test_segments_aligned_under_reordering(self):
        # cull Morton-sorts rays inside the step; recorded segments must
        # still pair each start with ITS OWN hit point
        from lightpycl_tpu.sources import CollimatedSource
        from lightpycl_tpu.tracer.engine import Tracer

        els = [oe.parabolic_mirror(0.5, 2.0, reflectivity=0.9),
               oe.hemisphere(10.0, name="dome")]
        src = CollimatedSource(center=(0, 0, 3), direction=(0, 0, -1),
                               diameter=1.5, ray_count=256, power=1.0, seed=3)
        res = Tracer().trace(src, els, trace_iterations=3, mode="host",
                             record_paths=True, cull=True)
        assert res.segments
        for starts, ends, alive in res.segments:
            seg = ends[alive] - starts[alive]
            ln = np.linalg.norm(seg, axis=1, keepdims=True)
            ok = ln[:, 0] > 1e-6
            u = seg[ok] / ln[ok]
            # every segment must be a straight ray path: unit direction,
            # and for the first bounce all downward (-z source)
            assert np.allclose(np.linalg.norm(u, axis=1), 1.0, atol=1e-5)
        first_starts, first_ends, first_alive = res.segments[0]
        d0 = first_ends[first_alive] - first_starts[first_alive]
        assert (d0[:, 2] < 0).all()  # all first segments travel -z


class TestAutoCull:
    """cull=None (the default) resolves automatically in the engine:
    ON for coherent bundles (the mask can bite), OFF for isotropic
    sources and mesh2d (the accelerator must
    earn its keep by default, bit-identically)."""

    def _els(self):
        return [oe.parabolic_mirror(0.5, 2.0, reflectivity=0.9),
                oe.hemisphere(10.0, name="dome")]

    def test_collimated_auto_enables(self):
        from lightpycl_tpu.sources import CollimatedSource
        from lightpycl_tpu.tracer.engine import Tracer

        src = CollimatedSource(center=(0, 0, 3), direction=(0, 0, -1),
                               diameter=1.5, ray_count=512, power=1.0,
                               seed=3)
        tr = Tracer()
        o, d, p = src.sample()
        cfg = tr._resolve_cull(TraceConfig(), "device",
                               rays=L.RayBatch.from_arrays(o, d, p))
        assert cfg.cull is True
        # and the auto-culled trace matches an explicit brute one
        r_auto = tr.trace(src, self._els(), trace_iterations=5,
                          mode="device")
        r_off = Tracer().trace(src, self._els(), trace_iterations=5,
                               mode="device", cull=False)
        for k in ("measured", "absorbed", "escaped"):
            assert r_auto.ledger[k] == pytest.approx(
                r_off.ledger[k], rel=1e-4, abs=1e-7)
        assert np.allclose(r_auto.hist, r_off.hist, atol=1e-5)

    def test_isotropic_auto_disables(self):
        from lightpycl_tpu.sources import light_source
        from lightpycl_tpu.tracer.engine import Tracer

        ls = light_source(center=(0, 0, 0), direction=(0, 0, 1),
                          power=1.0, ray_count=512, seed=1,
                          polar_max=np.pi)
        o, d, p = ls.sample()
        cfg = Tracer()._resolve_cull(TraceConfig(), "device",
                                     rays=L.RayBatch.from_arrays(o, d, p))
        assert cfg.cull is False

    def test_explicit_override_respected(self):
        from lightpycl_tpu.tracer.engine import Tracer

        tr = Tracer()
        assert tr._resolve_cull(TraceConfig(cull=False), "device").cull \
            is False
        assert tr._resolve_cull(TraceConfig(cull=True), "device").cull \
            is True

    def test_mesh2d_auto_enables_for_coherent(self):
        """r5: the 2-D mesh path gets the accelerator too — per-shard
        masks over each shard's contiguous sorted-tile slice, so auto
        resolves by bundle coherence exactly like the 1-D paths."""
        from lightpycl_tpu.sources import CollimatedSource
        from lightpycl_tpu.tracer.engine import Tracer

        src = CollimatedSource(center=(0, 0, 3), direction=(0, 0, -1),
                               diameter=1.5, ray_count=256, power=1.0,
                               seed=3)
        o, d, p = src.sample()
        cfg = Tracer()._resolve_cull(TraceConfig(), "mesh2d",
                                     rays=L.RayBatch.from_arrays(o, d, p))
        assert cfg.cull is True

    def _bundle(self, n):
        from lightpycl_tpu.tracer.engine import Tracer

        tr = Tracer()
        tr.set_elements(self._els(), spatial_sort=True)
        rng = np.random.default_rng(11)
        o = jnp.asarray(rng.uniform(-0.7, 0.7, (n, 3)).astype(np.float32))
        o = o.at[:, 2].set(3.0)
        d = jnp.tile(jnp.asarray([[0.01, -0.02, -1.0]], jnp.float32),
                     (n, 1))
        return tr.scene, o, d / jnp.linalg.norm(d, axis=1, keepdims=True)

    @pytest.mark.parametrize("R,K,cull_tile", [(64, 16, 16), (32, 8, 16),
                                               (128, 8, 8)])
    def test_multiword_mask_rows_exact(self, R, K, cull_tile):
        """Mask rows of several 32-bit words (more than 32 cull tiles)
        must still match brute force exactly."""
        scene, o, d = self._bundle(512)
        n_tiles = -(-scene.num_triangles_padded // cull_tile)
        assert n_tiles > 32  # at least two words per mask row
        kw = dict(ray_block=R, tri_tile=K, cull_tile=cull_tile,
                  interpret=True)
        t0, i0 = intersect_gpu(scene, o, d, CFG, cull=False, **kw)
        t1, i1 = intersect_gpu(scene, o, d, CFG, cull=True, **kw)
        np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
        np.testing.assert_array_equal(np.asarray(t0), np.asarray(t1))

    def test_all_zero_mask_row_misses(self):
        """A ray block whose mask row is all zeros (here: no live rays)
        skips every tile, so all its rays miss."""
        from lightpycl_tpu.ops.intersect_gpu import pack_mask

        scene, o, d = self._bundle(256)
        alive = jnp.zeros((256,), bool).at[128:].set(True)
        t, i = intersect_gpu(scene, o, d, CFG, cull=True, alive=alive,
                             ray_block=128, tri_tile=32, cull_tile=64,
                             interpret=True)
        t, i = np.asarray(t), np.asarray(i)
        assert (i[:128] == -1).all() and np.isinf(t[:128]).all()
        assert (i[128:] >= 0).all()
        words = np.asarray(pack_mask(jnp.asarray([[1] * 40, [0] * 40])))
        assert words.shape == (2, 2) and (words[1] == 0).all()
        assert words[0, 0] == -1 and words[0, 1] == 0xFF

    def test_batched_auto_enables_and_conserves(self):
        from lightpycl_tpu.sources import CollimatedSource
        from lightpycl_tpu.tracer.engine import Tracer

        src = CollimatedSource(center=(0, 0, 3), direction=(0, 0, -1),
                               diameter=1.5, ray_count=256, power=1.0,
                               seed=3)
        tr = Tracer()
        res = tr.trace_batched(src, total_rays=512, batch_size=256,
                               elements=self._els(), seed=5,
                               trace_iterations=5)
        led = res.ledger
        acc = (led["measured"] + led["absorbed"] + led["escaped"]
               + led["culled"])
        assert acc == pytest.approx(led["emitted"], rel=1e-5)


class TestCullReductionOrder:
    """Pin the exactness CONTRACT precisely: per-pair
    hit results (t, tri index) are bit-identical with the cull on — that
    is what 'conservative mask' guarantees — while REDUCED sums (detected
    power, histogram bins) may differ by f32 summation order after the
    per-bounce Morton resort, observed ~6e-6 rel at 16M rays on chip."""

    def test_per_pair_exact_sums_within_reduction_jitter(self):
        from lightpycl_tpu.sources import CollimatedSource
        from lightpycl_tpu.tracer.engine import Tracer

        els = [oe.parabolic_mirror(0.5, 2.0, reflectivity=0.9),
               oe.sphere(6.0, material="measure", name="dome")]
        src = CollimatedSource(center=(0, 0, 3), direction=(0, 0, -1),
                               diameter=1.5, ray_count=4096, power=1.0,
                               seed=9)
        r0 = Tracer().trace(src, els, trace_iterations=4, mode="device",
                            cull=False)
        r1 = Tracer().trace(src, els, trace_iterations=4, mode="device",
                            cull=True)
        # reduced sums: equal within f32 reduction-order jitter, and that
        # jitter really is tiny (the claim the docs now make)
        assert r1.ledger["measured"] == pytest.approx(
            r0.ledger["measured"], rel=2e-5)
        assert abs(r1.ledger["measured"] - r0.ledger["measured"]) <= \
            2e-5 * max(r0.ledger["measured"], 1e-30)
        # per-pair contract at the kernel level: identical hit indices/t
        o, d, _ = src.sample()
        o = np.asarray(o, np.float32)
        d = np.asarray(d, np.float32)
        scene, _ = build_scene(els)
        kw = dict(ray_block=128, tri_tile=256, interpret=True)
        t0, i0 = map(np.asarray, intersect_gpu(scene, o[:256], d[:256],
                                                  CFG, cull=False, **kw))
        t1, i1 = map(np.asarray, intersect_gpu(scene, o[:256], d[:256],
                                                  CFG, cull=True, **kw))
        np.testing.assert_array_equal(i0, i1)
        both = i0 >= 0
        np.testing.assert_array_equal(t0[both], t1[both])
