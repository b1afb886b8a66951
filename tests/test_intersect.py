"""Intersection tests: jnp path vs the GPU kernel (Pallas interpreter) vs
the float64 Möller–Trumbore oracle; epsilon guards; misses; the kernel
wrapper's padding and the platform dispatch.
(SURVEY.md §7 Stage 1 + Stage 3 correctness cross-check.)
"""

import jax.numpy as jnp
import numpy as np
import pytest

from lightpycl_tpu.geometry.mesh import GeoObject
from lightpycl_tpu.geometry.primitives import OpticalElements
from lightpycl_tpu.ops import intersect_gpu as ig
from lightpycl_tpu.tracer.config import TraceConfig
from lightpycl_tpu.tracer.oracle import _mt_nearest_hit
from lightpycl_tpu.tracer.scene import build_scene
from lightpycl_tpu.tracer.step import intersect_jnp

oe = OpticalElements(n_segments=16, n_radial=6)
CFG = TraceConfig()


def random_rays(rng, n, span=1.5):
    o = rng.uniform(-span, span, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def scene_and_soup():
    els = [
        oe.parabolic_mirror(0.5, 2.0),
        oe.hemisphere(4.0),
        oe.cube(0.4, center=(0.6, 0.1, 0.8), material="refractive", ior=1.5),
        oe.biconvex_lens(1.0, 0.8, 0.2, center=(-0.5, 0, 1.0)),
    ]
    scene, _ = build_scene(els)
    tv = np.concatenate([e.triangle_vertices() for e in els])
    return scene, tv


class TestSingleTriangle:
    def setup_method(self):
        tri = GeoObject(
            np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0.0]]),
            np.array([[0, 1, 2]]),
        )
        self.scene, _ = build_scene([tri])

    def _hit(self, o, d):
        t, i = intersect_jnp(
            self.scene, jnp.asarray([o], jnp.float32), jnp.asarray([d], jnp.float32), CFG
        )
        return float(t[0]), int(i[0])

    def test_direct_hit(self):
        t, i = self._hit([0.2, 0.2, 1.0], [0, 0, -1])
        assert i == 0 and t == pytest.approx(1.0, abs=1e-6)

    def test_miss_outside(self):
        t, i = self._hit([0.9, 0.9, 1.0], [0, 0, -1])
        assert i == -1 and np.isinf(t)

    def test_parallel_miss(self):
        t, i = self._hit([0.2, 0.2, 1.0], [1, 0, 0])
        assert i == -1

    def test_behind_miss(self):
        t, i = self._hit([0.2, 0.2, -1.0], [0, 0, -1])
        assert i == -1

    def test_eps_guard_self_hit(self):
        # origin ON the triangle: t ~ 0 must be rejected
        t, i = self._hit([0.2, 0.2, 0.0], [0, 0, -1])
        assert i == -1

    def test_beyond_max_len(self):
        cfg = CFG.replace(max_ray_len=0.5)
        t, i = intersect_jnp(
            self.scene, jnp.asarray([[0.2, 0.2, 1.0]], jnp.float32),
            jnp.asarray([[0, 0, -1.0]], jnp.float32), cfg
        )
        assert int(i[0]) == -1


class TestCrossImplementation:
    def test_jnp_matches_oracle(self, rng):
        scene, tv = scene_and_soup()
        o, d = random_rays(rng, 500)
        t1, i1 = map(np.asarray, intersect_jnp(scene, jnp.asarray(o), jnp.asarray(d), CFG))
        t3, i3 = _mt_nearest_hit(
            o.astype(np.float64), d.astype(np.float64),
            tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0],
            CFG.eps, CFG.eps_bary, CFG.max_ray_len,
        )
        assert ((i1 >= 0) == (i3 >= 0)).mean() > 0.998  # grazing-edge ties allowed
        both = (i1 >= 0) & (i3 >= 0)
        assert np.abs(t1[both] - t3[both]).max() < 1e-4

    def test_pallas_interpret_matches_jnp(self, rng):
        scene, _ = scene_and_soup()
        o, d = random_rays(rng, 300)
        t1, i1 = map(np.asarray, intersect_jnp(scene, jnp.asarray(o), jnp.asarray(d), CFG))
        t2, i2 = map(
            np.asarray,
            ig.intersect_gpu(scene, jnp.asarray(o), jnp.asarray(d), CFG,
                             ray_block=128, tri_tile=256, interpret=True),
        )
        assert (i1 == i2).all()
        both = np.isfinite(t1)
        assert np.allclose(t1[both], t2[both], atol=1e-5)

    def test_pallas_odd_sizes(self, rng):
        # non-multiple ray counts and tile sizes vs triangle count
        scene, _ = scene_and_soup()
        o, d = random_rays(rng, 77)
        t1, i1 = map(np.asarray, intersect_jnp(scene, jnp.asarray(o), jnp.asarray(d), CFG))
        t2, i2 = map(
            np.asarray,
            ig.intersect_gpu(scene, jnp.asarray(o), jnp.asarray(d), CFG,
                             ray_block=256, tri_tile=128, interpret=True),
        )
        assert (i1 == i2).all()

    def test_nearest_of_two(self):
        # two stacked parallel squares: must report the nearer one
        near = oe.rectangle(1, 1, center=(0, 0, 1))
        far = oe.rectangle(1, 1, center=(0, 0, 2))
        scene, _ = build_scene([near, far])
        t, i = intersect_jnp(
            scene, jnp.asarray([[0.1, 0.1, 0.0]], jnp.float32),
            jnp.asarray([[0, 0, 1.0]], jnp.float32), CFG
        )
        assert float(t[0]) == pytest.approx(1.0, abs=1e-6)
        assert int(i[0]) < near.num_triangles


class TestKernelWrapper:
    """The GPU kernel's wrapper, run in the Pallas interpreter: ray and
    triangle padding, launch shapes, and the platform dispatch."""

    @pytest.mark.parametrize("n_rays,R", [(1, 32), (77, 32), (200, 64),
                                          (129, 128)])
    def test_ray_count_not_multiple_of_block(self, rng, n_rays, R):
        scene, _ = scene_and_soup()
        o, d = random_rays(rng, n_rays)
        t1, i1 = map(np.asarray, intersect_jnp(scene, jnp.asarray(o),
                                               jnp.asarray(d), CFG))
        t2, i2 = map(np.asarray, ig.intersect_gpu(
            scene, jnp.asarray(o), jnp.asarray(d), CFG, ray_block=R,
            tri_tile=32, interpret=True))
        assert t2.shape == (n_rays,) and i2.shape == (n_rays,)
        assert i2.dtype == np.int32
        np.testing.assert_array_equal(i1, i2)

    @pytest.mark.parametrize("K", [16, 64, 512])
    def test_triangle_count_not_multiple_of_tile(self, rng, K):
        # the scene pads to 768 triangles: K=512 pads the stream to 1024
        scene, _ = scene_and_soup()
        o, d = random_rays(rng, 128)
        t1, i1 = map(np.asarray, intersect_jnp(scene, jnp.asarray(o),
                                               jnp.asarray(d), CFG))
        t2, i2 = map(np.asarray, ig.intersect_gpu(
            scene, jnp.asarray(o), jnp.asarray(d), CFG, ray_block=64,
            tri_tile=K, interpret=True))
        np.testing.assert_array_equal(i1, i2)
        both = i1 >= 0
        np.testing.assert_allclose(t2[both], t1[both], rtol=1e-6)

    def test_padding_rows_never_hit(self, rng):
        scene, tv = scene_and_soup()
        w4 = np.asarray(ig.pack_w4(scene, 512))
        assert w4.shape == (4, 2 * 3 * 512)
        o, d = random_rays(rng, 256, span=3.0)
        for cull in (False, True):
            _, i = ig.intersect_gpu(scene, jnp.asarray(o), jnp.asarray(d),
                                    CFG, cull=cull, ray_block=64,
                                    tri_tile=512, cull_tile=512,
                                    interpret=True)
            assert np.asarray(i).max() < len(tv)

    def test_all_miss_rows(self):
        # rays pointing away from everything: t = +inf, index -1
        scene, _ = scene_and_soup()
        o = np.tile([[0.0, 0.0, 50.0]], (40, 1)).astype(np.float32)
        d = np.tile([[0.0, 0.0, 1.0]], (40, 1)).astype(np.float32)
        t, i = map(np.asarray, ig.intersect_gpu(
            scene, jnp.asarray(o), jnp.asarray(d), CFG, interpret=True))
        assert (i == -1).all() and np.isinf(t).all()

    def test_t_max_window_on_the_winner(self):
        tri = GeoObject(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0.0]]),
                        np.array([[0, 1, 2]]))
        scene, _ = build_scene([tri])
        o = jnp.asarray([[0.2, 0.2, 1.0], [0.2, 0.2, 0.3]], jnp.float32)
        d = jnp.asarray([[0, 0, -1.0], [0, 0, -1.0]], jnp.float32)
        t, i = ig.intersect_gpu(scene, o, d, CFG.replace(max_ray_len=0.5),
                                interpret=True)
        assert np.asarray(i).tolist() == [-1, 0]
        assert float(t[1]) == pytest.approx(0.3, abs=1e-6)

    def test_dispatch_cpu_uses_reference(self, monkeypatch):
        from lightpycl_tpu.tracer import step

        called = []
        monkeypatch.setattr(ig, "intersect_gpu",
                            lambda *a, **k: called.append(k))
        scene, _ = scene_and_soup()
        o = jnp.zeros((4, 3), jnp.float32)
        d = jnp.ones((4, 3), jnp.float32) / np.sqrt(3)
        t, i = step.intersect(scene, o, d, CFG)
        assert not called and i.shape == (4,)

    def test_dispatch_gpu_uses_compiled_kernel(self, monkeypatch):
        from lightpycl_tpu.tracer import step

        called = []

        def fake(*a, **k):
            called.append(k)
            return "kernel"

        monkeypatch.setattr(ig, "intersect_gpu", fake)
        monkeypatch.setattr(step.jax, "default_backend", lambda: "gpu")
        scene, _ = scene_and_soup()
        o = jnp.zeros((4, 3), jnp.float32)
        assert step.intersect(scene, o, o, CFG, alive=None) == "kernel"
        assert called and not called[0].get("interpret", False)
        # backend='jnp' keeps the reference on any platform
        t, i = step.intersect(scene, o, o + 1.0, CFG.replace(backend="jnp"))
        assert len(called) == 1 and i.shape == (4,)

    def test_unknown_backend_raises(self):
        from lightpycl_tpu.tracer import step

        scene, _ = scene_and_soup()
        o = jnp.zeros((4, 3), jnp.float32)
        with pytest.raises(ValueError, match="backend"):
            step.intersect(scene, o, o, CFG.replace(backend="pallas"))

    def test_kernel_default_is_not_interpreted(self):
        import inspect

        sig = inspect.signature(ig.intersect_gpu)
        assert sig.parameters["interpret"].default is False

    @pytest.mark.gpu
    def test_compiled_kernel_matches_reference(self, gpu, rng):
        scene, _ = scene_and_soup()
        o, d = random_rays(rng, 4096)
        _, i1 = intersect_jnp(scene, jnp.asarray(o), jnp.asarray(d), CFG)
        _, i2 = ig.intersect_gpu(scene, jnp.asarray(o), jnp.asarray(d), CFG)
        assert (np.asarray(i1) == np.asarray(i2)).mean() >= 0.9999
