"""Differentiable EXACT-surface design (diff.analytic_singlet_scene +
quadric_intersect_diff): gradients of curvature/conic/thickness with no
tessellation noise.

The headline anchors convert two documented mesh-path limitations
(ROADMAP.md: Coddington best-form is tessellation-limited;
tests/test_diff.py recovers the stigmatic conic only to +-0.35 with a
6e-3 facet spot floor) into exact results: the stigmatic singlet's loss
landscape minimizes AT k = -n^2 with a ~1e-7 floor, and the best-form
scan resolves an interior minimum bracketing the thin-lens q*.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lightpycl_tpu import diff
from lightpycl_tpu.tracer.config import TraceConfig
from lightpycl_tpu.tracer.rays import RayBatch

N_GLASS = 1.5


class TestQuadricDiffCore:
    def test_matches_forward_analytic_path(self):
        """Meridional crossings through the diff analytic singlet equal the
        oracle-validated forward-engine values (tests/test_analytic.py
        plano-convex: paraxial crossing -> 1.0499)."""
        cfg = TraceConfig(backend="jnp")
        scene = diff.analytic_singlet_scene(0.0, -2.0, 0.05, 0.2, 1.5)
        hs = np.array([0.005, 0.01, 0.02, 0.04])
        o = jnp.asarray(np.stack([hs, 0 * hs, np.full_like(hs, -0.5)],
                                 axis=1), jnp.float32)
        d = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (4, 1))
        rays = RayBatch.from_arrays(o, d, jnp.full((4,), 0.25), capacity=32)
        _, (eo, ed, ep) = diff.trace_diff_analytic(scene, rays, cfg, 5,
                                                   collect_escaped=True)
        eo, ed, ep = np.asarray(eo), np.asarray(ed), np.asarray(ep)
        m = (ep > 0.2) & (ed[:, 2] > 0.5)
        assert m.sum() == 4
        z_cross = eo[m, 2] - eo[m, 0] / ed[m, 0] * ed[m, 2]
        expect = [1.0498874, 1.0495499, 1.0481987, 1.0427797]
        np.testing.assert_allclose(sorted(z_cross, reverse=True), expect,
                                   atol=2e-5)

    def test_ad_matches_finite_difference(self):
        loss = diff.make_analytic_spot_loss(ior=1.5, thickness=0.2,
                                            aperture_radius=0.4,
                                            n_rays=120)
        g = jax.grad(loss, argnums=(0, 1, 4))(1.0, -1.0, 0.0, 0.0, 1.1)
        eps = 1e-3
        for i, (args_p, args_m) in enumerate([
            ((1.0 + eps, -1.0, 0.0, 0.0, 1.1),
             (1.0 - eps, -1.0, 0.0, 0.0, 1.1)),
            ((1.0, -1.0 + eps, 0.0, 0.0, 1.1),
             (1.0, -1.0 - eps, 0.0, 0.0, 1.1)),
            ((1.0, -1.0, 0.0, 0.0, 1.1 + eps),
             (1.0, -1.0, 0.0, 0.0, 1.1 - eps)),
        ]):
            fd = (float(loss(*args_p)) - float(loss(*args_m))) / (2 * eps)
            assert float(g[i]) == pytest.approx(fd, rel=5e-2)


class TestStigmaticSinglet:
    """Flat-front singlet at f/3.3; the exact stigmatic exit surface is
    the Descartes hyperbola k = -n^2."""

    def _loss(self):
        n, f, t_c = N_GLASS, 3.0, 0.15
        c2 = -1.0 / ((n - 1.0) * f)
        lf = diff.make_analytic_spot_loss(ior=n, thickness=t_c,
                                          aperture_radius=0.6, n_rays=300,
                                          beam_fill=0.75)
        z_plane = t_c + f
        return jax.jit(lambda k2: lf(0.0, c2, 0.0, k2, z_plane))

    def test_landscape_minimum_is_exact(self):
        """At k = -n^2 the spot collapses to f32 noise (~1e-7) — five
        orders below the spherical singlet and four below the mesh path's
        facet floor (test_diff.py asserts 6e-3 there)."""
        loss = self._loss()
        v_star = float(loss(-N_GLASS * N_GLASS))
        assert v_star < 1e-6
        assert float(loss(0.0)) > 1e-2          # sphere: heavy SA
        assert float(loss(-2.1)) > 100 * v_star  # sharp, centered minimum
        assert float(loss(-2.4)) > 100 * v_star

    def test_gradient_descent_recovers_conic(self):
        import optax

        loss = self._loss()
        vg = jax.jit(jax.value_and_grad(loss))
        opt = optax.adam(0.15)
        k2 = jnp.float32(0.0)
        st = opt.init(k2)
        best_v, best_k = np.inf, 0.0
        for _ in range(60):
            v, g = vg(k2)
            if float(v) < best_v:
                best_v, best_k = float(v), float(k2)
            u, st = opt.update(g, st)
            k2 = optax.apply_updates(k2, u)
        assert best_k == pytest.approx(-N_GLASS * N_GLASS, abs=0.02)
        assert best_v < 1e-4


class TestBestForm:
    def test_coddington_basin(self):
        """Best-form scan at f/5: spot RMS has an interior minimum in the
        shape factor q = (c1+c2)/(c1-c2) bracketing the thin-lens optimum
        q* = 2(n^2-1)/(n+2) ~ 0.714 (thick-lens + fifth-order terms shift
        it within the basin). The meshed version cannot resolve this
        (ROADMAP.md negative result) — facet blur exceeds the whole
        q-contrast."""
        n, X = N_GLASS, 2.0
        lf = diff.make_analytic_spot_loss(ior=n, thickness=0.05,
                                          aperture_radius=0.3, n_rays=300,
                                          beam_fill=0.33)

        zs = jnp.linspace(0.9, 1.2, 61)
        batch = jax.jit(jax.vmap(
            lambda z, q: lf(X * (q + 1) / 2, X * (q - 1) / 2, 0.0, 0.0, z),
            in_axes=(0, None)))

        def best(q):
            return float(jnp.min(batch(zs, jnp.float32(q))))

        v_lo, v_star, v_hi = best(0.0), best(0.7), best(1.4)
        assert v_star < v_lo * 0.85
        assert v_star < v_hi * 0.85
