"""Light-source tests: power normalization, directivity statistics,
collimated bundles, host vs on-device sampling (SURVEY.md §7 Stage 0).
"""

import jax
import numpy as np
import pytest

from lightpycl_tpu.sources import CollimatedSource, LightSource, lambertian, light_source


class TestLightSource:
    def test_power_normalized(self):
        ls = light_source(power=2.5, ray_count=5000, directivity=lambertian)
        _, _, p = ls.sample()
        assert p.sum() == pytest.approx(2.5, rel=1e-12)
        assert (p >= 0).all()

    def test_directions_unit_and_in_cone(self):
        ls = LightSource(direction=(0, 1, 0), polar_max=0.5, ray_count=2000)
        _, d, _ = ls.sample()
        assert np.allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-12)
        cos = d @ np.array([0, 1, 0.0])
        assert (cos >= np.cos(0.5) - 1e-12).all()

    def test_weighted_matches_sampled_distribution(self):
        # mean polar angle under cos-weighting must agree between modes
        w = LightSource(directivity=lambertian, ray_count=20000, mode="weighted", seed=3)
        s = LightSource(directivity=lambertian, ray_count=20000, mode="sampled", seed=4)
        _, dw, pw = w.sample()
        _, ds, ps = s.sample()
        mean_w = (np.arccos(dw[:, 2]) * pw).sum() / pw.sum()
        mean_s = (np.arccos(ds[:, 2]) * ps).sum() / ps.sum()
        assert mean_w == pytest.approx(mean_s, abs=0.02)
        # analytic: E[theta] under cos weighting over hemisphere = pi/4 - ... ≈ 0.5708
        ana = np.pi / 4
        assert mean_w == pytest.approx(ana, abs=0.02)

    def test_isotropic_uniform_cap(self):
        ls = LightSource(ray_count=50000, polar_max=np.pi / 2, seed=7)
        _, d, _ = ls.sample()
        # z uniform on [0,1] for uniform hemisphere sampling
        assert d[:, 2].mean() == pytest.approx(0.5, abs=0.01)

    def test_on_device_matches_host_statistics(self):
        ls = LightSource(directivity=None, ray_count=30000, power=1.0)
        o, d, p = ls.rays_on_device(jax.random.key(0))
        assert float(p.sum()) == pytest.approx(1.0, rel=1e-5)
        assert np.asarray(d)[:, 2].mean() == pytest.approx(0.5, abs=0.02)
        assert np.allclose(np.asarray(o), np.zeros(3), atol=1e-7)


class TestCollimated:
    def test_parallel_and_in_aperture(self):
        cs = CollimatedSource(direction=(0, 0, -1), diameter=2.0,
                              center=(0, 0, 5), ray_count=4000, power=3.0)
        o, d, p = cs.sample()
        assert np.allclose(d, [0, 0, -1])
        r = np.linalg.norm(o[:, :2], axis=1)
        assert (r <= 1.0 + 1e-12).all()
        assert p.sum() == pytest.approx(3.0)
        # uniform over disc: E[r^2] = R^2/2
        assert (r ** 2).mean() == pytest.approx(0.5, abs=0.02)

    def test_on_device(self):
        cs = CollimatedSource(diameter=1.0, ray_count=8192)
        o, d, p = cs.rays_on_device(jax.random.key(1))
        assert np.allclose(np.asarray(d), [0, 0, 1])
        assert float(p.sum()) == pytest.approx(1.0, rel=1e-5)


class TestDivergence:
    def test_collimated_divergence_cone(self):
        cs = CollimatedSource(direction=(0, 0, 1), diameter=0.5,
                              ray_count=5000, divergence=0.1, seed=2)
        _, d, _ = cs.sample()
        cos = d @ np.array([0, 0, 1.0])
        assert (cos >= np.cos(0.1) - 1e-12).all()
        assert cos.min() < np.cos(0.02)  # actually spread, not collimated

    def test_divergence_on_device_matches_host_statistics(self):
        """rays_on_device must honor `divergence` (it used to silently emit
        the exact axis direction): mean direction + RMS divergence of the
        device batch match the host sample()."""
        cs = CollimatedSource(direction=(0, 1, 1), diameter=0.5,
                              ray_count=20000, divergence=0.15, seed=3)
        _, dh, _ = cs.sample()
        _, dd, _ = cs.rays_on_device(jax.random.key(7))
        dd = np.asarray(dd, np.float64)
        axis = np.array([0, 1, 1.0]) / np.sqrt(2.0)
        for d in (dh, dd):
            cos = np.clip(d @ axis, -1, 1)
            ang = np.arccos(cos)
            assert (cos >= np.cos(0.15) - 1e-5).all()
            # uniform in cone: E[theta^2] is the same for both samplers
            assert np.sqrt((ang ** 2).mean()) == pytest.approx(
                np.sqrt((np.arccos(np.clip(dh @ axis, -1, 1)) ** 2).mean()),
                rel=0.03)
        assert np.abs(dd.mean(0) - dh.mean(0)).max() < 5e-3

    def test_rejection_envelope_recovers_from_spike(self):
        """A directivity whose peak hides between the 64x64 probe-grid
        nodes must still be sampled from the full density (the envelope
        rebuilds and restarts when it observes a larger value)."""
        from lightpycl_tpu.sources import LightSource

        # narrow gaussian spike at polar=0.31, azimuth arbitrary: grid step
        # over polar is polar_max/63 ~ 0.025, spike sigma is comparable but
        # the scale factor makes mid-cell values exceed node values * 1.1
        def spiky(az, pol):
            return 1.0 + 200.0 * np.exp(-((pol - 0.3137) / 0.004) ** 2)

        ls = LightSource(directivity=spiky, ray_count=4000, mode="sampled",
                         polar_max=1.5, seed=9)
        o, d, p = ls.sample()
        pol = np.arccos(np.clip(d[:, 2], -1, 1))
        # the spike must be visibly over-represented vs the flat background
        in_spike = np.abs(pol - 0.3137) < 0.012
        frac = in_spike.mean()
        # flat density would put ~sin(0.31)*0.024/(1-cos(1.5)) ~ 0.8% here
        assert frac > 0.02


class TestHexapolar:
    def test_grid_is_deterministic_and_in_aperture(self):
        cs = CollimatedSource(diameter=2.0, ray_count=200,
                              sampling="hexapolar")
        o1, d1, p1 = cs.sample()
        o2, d2, p2 = cs.sample()
        np.testing.assert_array_equal(o1, o2)
        r = np.linalg.norm(o1[:, :2], axis=1)
        assert (r <= 1.0 + 1e-12).all()
        assert r.min() == 0.0  # chief ray
        assert p1.sum() == pytest.approx(1.0)
        # roughly uniform areal density: mean r^2 ~ R^2/2 like the random disc
        assert (r ** 2).mean() == pytest.approx(0.5, abs=0.08)

    def test_unknown_sampling_rejected(self):
        with pytest.raises(ValueError, match="sampling"):
            CollimatedSource(sampling="spiral").sample()

    def test_hexapolar_on_device_matches_host(self):
        """rays_on_device must honor the deterministic hexapolar grid
        (regression: it used to silently fall back to random sampling)."""
        cs = CollimatedSource(diameter=2.0, ray_count=100,
                              sampling="hexapolar")
        oh, dh, ph = cs.sample()
        od, dd, pd = cs.rays_on_device(jax.random.key(3))
        np.testing.assert_allclose(np.asarray(od), oh, atol=1e-6)
        np.testing.assert_allclose(np.asarray(dd), dh, atol=1e-6)

    def test_divergence_on_device_unit_norm(self):
        """device-side divergent directions must be unit vectors (the
        elementwise frame construction; a TF32-truncated matmul here
        would break unit norm and leak power)."""
        cs = CollimatedSource(direction=(0, 1, 1), diameter=0.5,
                              ray_count=4096, divergence=0.2, seed=3)
        _, dd, _ = cs.rays_on_device(jax.random.key(5))
        norms = np.linalg.norm(np.asarray(dd, np.float64), axis=1)
        np.testing.assert_allclose(norms, 1.0, atol=2e-6)


class TestHalton:
    """Quasi-Monte Carlo (low-discrepancy) sampling: sampling='halton'
    (extension; the reference samples pseudo-randomly only)."""

    def test_radical_inverse_exact(self):
        from lightpycl_tpu.sources import halton_sequence

        np.testing.assert_allclose(
            halton_sequence(7, 2),
            [1 / 2, 1 / 4, 3 / 4, 1 / 8, 5 / 8, 3 / 8, 7 / 8])
        np.testing.assert_allclose(
            halton_sequence(4, 3), [1 / 3, 2 / 3, 1 / 9, 4 / 9])

    def test_collimated_deterministic_and_low_discrepancy(self):
        n = 4096
        qmc = CollimatedSource(diameter=1.0, ray_count=n,
                               sampling="halton")
        o1, _, p1 = qmc.sample()
        o2, _, _ = qmc.sample()
        np.testing.assert_array_equal(o1, o2)        # no RNG at all
        assert p1.sum() == pytest.approx(1.0)
        r = np.linalg.norm(o1[:, :2], axis=1)
        assert (r <= 0.5).all()
        # the QMC win: aperture-averaged moments beat 1/sqrt(n) by far
        rnd, _, _ = CollimatedSource(diameter=1.0, ray_count=n,
                                     seed=7).sample()
        err_qmc = np.abs(o1[:, :2].mean(0)).max()
        err_rnd = np.abs(rnd[:, :2].mean(0)).max()
        assert err_qmc < 5e-4
        assert err_qmc < err_rnd / 5.0
        assert (r**2).mean() == pytest.approx(0.125, abs=1e-3)

    def test_collimated_on_device_matches_host(self):
        cs = CollimatedSource(diameter=2.0, ray_count=128,
                              sampling="halton")
        oh, dh, _ = cs.sample()
        od, dd, _ = cs.rays_on_device(jax.random.key(3))
        np.testing.assert_allclose(np.asarray(od), oh, atol=1e-6)
        np.testing.assert_allclose(np.asarray(dd), dh, atol=1e-6)

    def test_divergence_cone_halton(self):
        cs = CollimatedSource(diameter=0.5, ray_count=4096,
                              divergence=0.2, sampling="halton")
        _, d, _ = cs.sample()
        np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0,
                                   atol=1e-12)
        cz = d[:, 2]
        assert (cz >= np.cos(0.2) - 1e-12).all()
        # uniform-in-cap: mean cos = (1 + cos(mx)) / 2, QMC-tight
        assert cz.mean() == pytest.approx((1 + np.cos(0.2)) / 2, abs=5e-5)

    def test_area_source_halton(self):
        from lightpycl_tpu.sources import AreaSource

        a = AreaSource(radius=0.5, ray_count=4096, sampling="halton")
        o1, d1, p1 = a.sample()
        o2, _, _ = a.sample()
        np.testing.assert_array_equal(o1, o2)
        assert p1.sum() == pytest.approx(1.0)
        # lambertian: mean cos = 2/3, QMC-tight; surface mean centered
        assert d1[:, 2].mean() == pytest.approx(2 / 3, abs=1e-3)
        assert np.abs(o1[:, :2].mean(0)).max() < 5e-4
        # device path honors the same deterministic stream
        od, dd, _ = a.rays_on_device(jax.random.key(2))
        np.testing.assert_allclose(np.asarray(od), o1, atol=5e-6)
        np.testing.assert_allclose(np.asarray(dd), d1, atol=5e-6)
        with pytest.raises(ValueError, match="sampling"):
            AreaSource(sampling="sobol").sample()


class TestGaussianProfile:
    """TEM00 laser apodization: profile='gaussian' (extension; the
    reference's collimated source is uniform only)."""

    def test_encircled_power_matches_truncated_gaussian(self):
        w, a = 0.4, 0.5
        cs = CollimatedSource(diameter=2 * a, ray_count=8192,
                              sampling="halton", profile="gaussian",
                              waist=w)
        o, _, p = cs.sample()
        r = np.linalg.norm(o[:, :2], axis=1)
        assert (r <= a + 1e-12).all()
        assert p.sum() == pytest.approx(1.0)
        # encircled power within r0: (1-e^{-2r0^2/w^2}) / (1-e^{-2a^2/w^2})
        cap = 1.0 - np.exp(-2.0 * (a / w) ** 2)
        for r0 in (0.1, 0.25, 0.4):
            want = (1.0 - np.exp(-2.0 * (r0 / w) ** 2)) / cap
            got = p[r < r0].sum()
            assert got == pytest.approx(want, abs=2e-3), r0

    def test_hexapolar_gaussian_weights_powers(self):
        w = 0.3
        cs = CollimatedSource(diameter=1.0, ray_count=200,
                              sampling="hexapolar", profile="gaussian",
                              waist=w)
        o, _, p = cs.sample()
        r = np.linalg.norm(o[:, :2], axis=1)
        assert p.sum() == pytest.approx(1.0)
        # power ratio of two rays = intensity ratio at their radii
        i, j = r.argmin(), r.argmax()
        want = np.exp(-2.0 * (r[i] ** 2 - r[j] ** 2) / w**2)
        assert p[i] / p[j] == pytest.approx(want, rel=1e-6)

    def test_device_matches_host(self):
        cs = CollimatedSource(diameter=1.0, ray_count=256,
                              sampling="halton", profile="gaussian",
                              waist=0.3)
        oh, dh, ph = cs.sample()
        od, dd, pd = cs.rays_on_device(jax.random.key(1))
        np.testing.assert_allclose(np.asarray(od), oh, atol=5e-6)
        np.testing.assert_allclose(np.asarray(pd), ph, atol=1e-9)

    def test_halton_divergence_device_matches_host(self):
        cs = CollimatedSource(diameter=1.0, ray_count=256,
                              sampling="halton", divergence=0.15)
        oh, dh, _ = cs.sample()
        od, dd, _ = cs.rays_on_device(jax.random.key(1))
        np.testing.assert_allclose(np.asarray(dd), dh, atol=5e-6)

    def test_validation(self):
        with pytest.raises(ValueError, match="waist"):
            CollimatedSource(profile="gaussian").sample()
        with pytest.raises(ValueError, match="profile"):
            CollimatedSource(profile="tophat").sample()
