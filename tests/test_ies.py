"""IES LM-63 photometric IO (io/ies.py): write/read round trip, V(lambda)
weighting, flux conservation, and the LM-63 -> LightSource inverse path.

The reference has no photometric IO (SURVEY.md §3); these pin the
extension's physics: candela = lm/sr on the web nodes, the web's
solid-angle integral equals the binned lumens exactly, and a web-driven
source reproduces the web's directivity."""

import numpy as np
import pytest

from lightpycl_tpu.analysis import cie_xyz_cmf
from lightpycl_tpu.io.ies import (IESData, grid_flux, ies_directivity,
                                  ies_source, load_ies,
                                  luminous_intensity_grid, save_ies,
                                  LM_PER_W_555)


def _isotropic_dirs(rng, n, hemisphere=True):
    z = rng.uniform(0.0 if hemisphere else -1.0, 1.0, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    s = np.sqrt(1 - z**2)
    return np.stack([s * np.cos(phi), s * np.sin(phi), z], axis=1)


class TestGrid:
    def test_isotropic_uniform_candela(self):
        # uniform hemisphere, total 1 photopic W -> I = 683 / 2pi cd
        rng = np.random.default_rng(0)
        n = 400_000
        d = _isotropic_dirs(rng, n)
        p = np.full(n, 1.0 / n)
        c, vdeg, hdeg, lm = luminous_intensity_grid(d, p, n_vertical=10)
        assert lm == pytest.approx(LM_PER_W_555, rel=1e-12)
        expect = LM_PER_W_555 / (2 * np.pi)
        # the 0-degree node owns a tiny polar cap (~1.5k of the 400k rays)
        # -> ~2.6% MC sigma; everything else is sub-percent
        assert np.allclose(c, expect, rtol=0.10)
        assert abs(np.mean(c) / expect - 1.0) < 0.01
        assert vdeg[0] == 0.0 and vdeg[-1] == 90.0
        assert hdeg.tolist() == [0.0]

    def test_grid_flux_inverts_binning_axial(self):
        rng = np.random.default_rng(1)
        d = _isotropic_dirs(rng, 5000, hemisphere=False)
        p = rng.uniform(0.1, 2.0, 5000)
        c, vdeg, hdeg, lm = luminous_intensity_grid(d, p, n_vertical=19)
        assert vdeg[-1] == 180.0
        assert grid_flux(c, vdeg, hdeg) == pytest.approx(lm, rel=1e-12)

    def test_grid_flux_inverts_binning_full_web(self):
        rng = np.random.default_rng(2)
        d = _isotropic_dirs(rng, 5000)
        p = rng.uniform(0.1, 2.0, 5000)
        c, vdeg, hdeg, lm = luminous_intensity_grid(
            d, p, n_vertical=13, n_horizontal=25)
        assert hdeg[0] == 0.0 and hdeg[-1] == 360.0
        # the 360 column duplicates the 0 column
        assert np.allclose(c[0], c[-1])
        assert grid_flux(c, vdeg, hdeg) == pytest.approx(lm, rel=1e-12)

    def test_v_lambda_weighting(self):
        # 1 W at 555 nm -> 683 lm; at another wavelength the ratio is ybar
        d = np.array([[0.0, 0.0, 1.0]])
        p = np.array([1.0])
        _, _, _, lm555 = luminous_intensity_grid(
            d, p, wavelengths=np.array([0.555]))
        assert lm555 == pytest.approx(
            LM_PER_W_555 * cie_xyz_cmf([0.555])[0, 1], rel=1e-12)
        _, _, _, lm510 = luminous_intensity_grid(
            d, p, wavelengths=np.array([0.510]))
        ratio = cie_xyz_cmf([0.510])[0, 1] / cie_xyz_cmf([0.555])[0, 1]
        assert lm510 / lm555 == pytest.approx(ratio, rel=1e-12)

    def test_radiometric_units_passthrough(self):
        d = np.array([[0.0, 0.0, 1.0]])
        _, _, _, lm = luminous_intensity_grid(d, [2.0], lm_per_watt=1.0)
        assert lm == pytest.approx(2.0)

    def test_off_axis_luminaire(self):
        # all flux along +x with axis=+x lands at the 0-degree node
        d = np.repeat([[1.0, 0.0, 0.0]], 100, axis=0)
        p = np.full(100, 0.01)
        c, vdeg, _, _ = luminous_intensity_grid(
            d, p, axis=(1.0, 0.0, 0.0), n_vertical=10)
        assert c[0, 0] > 0
        assert np.all(c[0, 1:] == 0)


class TestRoundTrip:
    def test_save_load_exact(self, tmp_path):
        rng = np.random.default_rng(3)
        d = _isotropic_dirs(rng, 20000)
        p = rng.uniform(0.5, 1.5, 20000) / 20000
        f = tmp_path / "lum.ies"
        lm = save_ies(f, d, p, n_vertical=19, n_horizontal=13,
                      keywords={"LUMINAIRE": "traced bowl"})
        data = load_ies(f)
        assert data.photometric_type == 1
        assert data.n_lamps == 1
        assert data.keywords["LUMINAIRE"] == "traced bowl"
        assert data.keywords["MANUFAC"] == "lightpycl_tpu"
        assert data.lumens_per_lamp == pytest.approx(lm, rel=1e-8)
        assert data.total_lumens == pytest.approx(lm, rel=1e-8)
        assert data.watts == pytest.approx(p.sum(), rel=1e-8)
        c, vdeg, hdeg, _ = luminous_intensity_grid(
            d, p, n_vertical=19, n_horizontal=13)
        np.testing.assert_allclose(data.candela, c, rtol=1e-7)
        np.testing.assert_allclose(data.vertical_deg, vdeg, atol=1e-9)
        np.testing.assert_allclose(data.horizontal_deg, hdeg, atol=1e-9)

    def test_explicit_grid_and_multiplier(self, tmp_path):
        vdeg = np.linspace(0, 90, 10)
        c = np.cos(np.radians(vdeg))[None, :] * 100.0
        f = tmp_path / "lambertian.ies"
        save_ies(f, candela=c, vertical_deg=vdeg, horizontal_deg=[0.0])
        data = load_ies(f)
        np.testing.assert_allclose(data.candela, c, rtol=1e-8)
        # Lambertian: Phi = pi * I0 (node-binned approximation)
        assert data.total_lumens == pytest.approx(np.pi * 100.0, rel=0.01)

    def test_load_rejects_tilt(self, tmp_path):
        f = tmp_path / "tilted.ies"
        f.write_text("IESNA:LM-63-2002\nTILT=INCLUDE\n1 1 1 1 1 1 2 0 0 0\n")
        with pytest.raises(ValueError, match="TILT"):
            load_ies(f)

    def test_load_rejects_truncated(self, tmp_path):
        f = tmp_path / "short.ies"
        f.write_text("IESNA:LM-63-2002\nTILT=NONE\n"
                     "1 100 1 5 1 1 2 0 0 0\n1 1 0\n0 30 60\n")
        with pytest.raises(ValueError, match="web"):
            load_ies(f)

    def test_shape_mismatch_raises(self, tmp_path):
        with pytest.raises(ValueError, match="shape"):
            save_ies(tmp_path / "x.ies", candela=np.ones((2, 3)),
                     vertical_deg=[0, 45, 90], horizontal_deg=[0])


class TestDirectivity:
    def _lambertian(self):
        vdeg = np.linspace(0, 90, 19)
        c = np.maximum(np.cos(np.radians(vdeg)), 0.0)[None, :] * 50.0
        return IESData(vertical_deg=vdeg, horizontal_deg=np.array([0.0]),
                       candela=c, lumens_per_lamp=0.0, n_lamps=1, watts=0.0,
                       photometric_type=1, keywords={})

    def test_axial_interp_hits_nodes(self):
        data = self._lambertian()
        f = ies_directivity(data)
        pol = np.radians(data.vertical_deg)
        np.testing.assert_allclose(f(np.zeros_like(pol), pol),
                                   data.candela[0], rtol=1e-12)
        # azimuth is ignored for an axially symmetric web
        np.testing.assert_allclose(f(np.full_like(pol, 2.0), pol),
                                   data.candela[0], rtol=1e-12)

    def test_full_web_bilinear_and_wrap(self):
        vdeg = np.array([0.0, 90.0])
        hdeg = np.array([0.0, 90.0, 180.0, 270.0, 360.0])
        c = np.array([[1.0, 10.0],
                      [1.0, 20.0],
                      [1.0, 30.0],
                      [1.0, 20.0],
                      [1.0, 10.0]])
        data = IESData(vdeg, hdeg, c, 0.0, 1, 0.0, 1, {})
        f = ies_directivity(data)
        pol = np.pi / 2
        assert f(0.0, pol) == pytest.approx(10.0)
        assert f(np.pi / 2, pol) == pytest.approx(20.0)
        assert f(np.pi / 4, pol) == pytest.approx(15.0)
        # wrap: azimuth just below 2pi interpolates the 270..360 edge
        assert f(2 * np.pi - 1e-9, pol) == pytest.approx(10.0, rel=1e-6)
        assert f(-np.pi / 2, pol) == pytest.approx(20.0)  # negative wraps

    def test_quadrant_symmetry_fold(self):
        vdeg = np.array([0.0, 90.0])
        hdeg = np.array([0.0, 45.0, 90.0])
        c = np.array([[1.0, 2.0], [1.0, 5.0], [1.0, 8.0]])
        data = IESData(vdeg, hdeg, c, 0.0, 1, 0.0, 1, {})
        f = ies_directivity(data)
        pol = np.pi / 2
        for az in (np.radians(30), np.radians(150), np.radians(210),
                   np.radians(330)):
            assert f(az, pol) == pytest.approx(f(np.radians(30), pol))
        assert f(np.radians(135), pol) == pytest.approx(5.0)

    def test_bilateral_symmetry_fold(self):
        vdeg = np.array([0.0, 90.0])
        hdeg = np.array([0.0, 90.0, 180.0])
        c = np.array([[1.0, 2.0], [1.0, 5.0], [1.0, 8.0]])
        data = IESData(vdeg, hdeg, c, 0.0, 1, 0.0, 1, {})
        f = ies_directivity(data)
        pol = np.pi / 2
        assert f(np.radians(270), pol) == pytest.approx(5.0)
        assert f(np.radians(315), pol) == pytest.approx(f(np.radians(45), pol))


class TestIESSource:
    def test_source_reproduces_web(self, tmp_path):
        # Lambertian web -> source -> re-binned web matches (weighted mode
        # evaluates the directivity exactly, so only binning error remains)
        vdeg = np.linspace(0, 90, 19)
        I0 = 40.0
        c = np.maximum(np.cos(np.radians(vdeg)), 0.0)[None, :] * I0
        f = tmp_path / "lamb.ies"
        save_ies(f, candela=c, vertical_deg=vdeg, horizontal_deg=[0.0])
        src = ies_source(f, ray_count=200_000, seed=4)
        # default power = integrated flux ~ pi * I0
        assert src.power == pytest.approx(np.pi * I0, rel=0.01)
        o, d, p = src.sample()
        c2, vdeg2, _, lm2 = luminous_intensity_grid(
            d, p, lm_per_watt=1.0, n_vertical=10)
        assert lm2 == pytest.approx(src.power, rel=1e-9)
        expect = I0 * np.cos(np.radians(vdeg2))
        mask = expect > 0.1 * I0
        np.testing.assert_allclose(c2[0, mask], expect[mask], rtol=0.05)

    def test_source_traced_through_engine(self, tmp_path):
        # web source -> dome detector: detected flux == emitted flux, and
        # the measured directivity re-exports to a consistent IES file
        import lightpycl_tpu as L
        from lightpycl_tpu.tracer.engine import Tracer

        vdeg = np.linspace(0, 90, 10)
        c = (1.0 + np.cos(np.radians(2 * vdeg)))[None, :] * 10.0
        f = tmp_path / "web.ies"
        save_ies(f, candela=c, vertical_deg=vdeg, horizontal_deg=[0.0])
        src = ies_source(f, ray_count=20_000, seed=5)
        oe = L.optical_elements(n_segments=48, n_radial=16)
        dome = oe.hemisphere(radius=10.0, name="dome")
        res = Tracer().trace(src, [dome], trace_iterations=2)
        assert res.ledger["measured"] == pytest.approx(src.power, rel=1e-3)
        out = tmp_path / "traced.ies"
        lm = save_ies(out, res.measured_dir, res.measured_power,
                      lm_per_watt=1.0, n_vertical=10)
        assert lm == pytest.approx(res.ledger["measured"], rel=1e-6)
        back = load_ies(out)
        assert back.total_lumens == pytest.approx(lm, rel=1e-8)


class TestIlluminance:
    def test_uniform_beam_lux(self):
        # 1 photopic W uniformly over a 0.5 x 0.5 m patch -> 683/0.25 lux
        from lightpycl_tpu.analysis import illuminance_map

        rng = np.random.default_rng(6)
        n = 200_000
        xy = rng.uniform(-0.25, 0.25, (n, 2))
        pos = np.concatenate([xy, np.zeros((n, 1))], axis=1)
        p = np.full(n, 1.0 / n)
        lux, xe, ye = illuminance_map(pos, p, half_extent=0.25, bins=4)
        total_lm = np.sum(lux) * (xe[1] - xe[0]) * (ye[1] - ye[0])
        assert total_lm == pytest.approx(LM_PER_W_555, rel=1e-9)
        assert np.allclose(lux, LM_PER_W_555 / 0.25, rtol=0.04)

    def test_v_lambda_scaling(self):
        from lightpycl_tpu.analysis import illuminance_map

        pos = np.array([[0.0, 0.0, 0.0]])
        lux555, _, _ = illuminance_map(pos, [1.0], wavelengths=[0.555])
        lux510, _, _ = illuminance_map(pos, [1.0], wavelengths=[0.510])
        ratio = cie_xyz_cmf([0.510])[0, 1] / cie_xyz_cmf([0.555])[0, 1]
        assert lux510.sum() / lux555.sum() == pytest.approx(ratio, rel=1e-9)


class TestPhotometricTypeGuard:
    """Type B/A webs aim their angle grids along different axes; reading
    one as Type C silently rotates the distribution —
    directivity/source construction must refuse non-Type-C."""

    def _type_b(self):
        vdeg = np.linspace(0, 90, 10)
        c = np.ones((1, 10)) * 100.0
        return IESData(vertical_deg=vdeg, horizontal_deg=np.array([0.0]),
                       candela=c, lumens_per_lamp=0.0, n_lamps=1,
                       watts=0.0, photometric_type=2, keywords={})

    def test_directivity_rejects_type_b(self):
        import pytest

        from lightpycl_tpu.io.ies import ies_directivity
        with pytest.raises(ValueError, match="[Tt]ype"):
            ies_directivity(self._type_b())

    def test_source_rejects_type_a(self):
        import dataclasses

        import pytest

        from lightpycl_tpu.io.ies import ies_source
        data = dataclasses.replace(self._type_b(), photometric_type=3)
        with pytest.raises(ValueError, match="automotive"):
            ies_source(data)

    def test_load_still_parses_type_b(self, tmp_path):
        """Parsing stays format-faithful: only the consumers refuse."""
        p = tmp_path / "b.ies"
        rng = np.random.default_rng(0)
        d = _isotropic_dirs(rng, 512)
        save_ies(p, d, np.full(len(d), 1.0 / len(d)),
                 n_vertical=5, n_horizontal=1)
        text = p.read_text()
        # flip the photometric-type token (6th numeric after TILT=NONE)
        lines = text.splitlines()
        i = next(k for k, ln in enumerate(lines)
                 if ln.strip().upper().startswith("TILT="))
        toks = " ".join(lines[i + 1:]).split()
        assert toks[5] == "1"
        toks[5] = "2"
        p.write_text("\n".join(lines[: i + 1]) + "\n" + " ".join(toks))
        data = load_ies(p)
        assert data.photometric_type == 2
