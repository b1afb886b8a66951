"""Per-facet incident-flux maps (TraceConfig.flux_map).

Illumination-design extension on top of the reference's L5 analysis
(SURVEY.md §3 "Measurement & directivity analysis"): every valid surface
hit scatter-adds the arriving parent power into DetectorState.tri_flux;
analysis.surface_flux turns it into an irradiance map.
"""

import numpy as np
import pytest

import lightpycl_tpu as L
from lightpycl_tpu import analysis
from lightpycl_tpu.materials import Material
from lightpycl_tpu.sources import CollimatedSource, light_source
from lightpycl_tpu.tracer.config import TraceConfig
from lightpycl_tpu.tracer.engine import Tracer

oe = L.optical_elements(n_segments=32, n_radial=12)


def _measure_sphere(radius=2.0):
    s = oe.sphere(radius=radius)
    s.material = Material.MEASURE
    return s


class TestFluxMap:
    def test_disabled_by_default(self):
        tr = Tracer(TraceConfig(trace_iterations=2))
        ls = light_source(center=(0, 0, 0), direction=(0, 0, 1), power=1.0,
                          ray_count=256, seed=0, polar_max=np.pi)
        res = tr.trace(ls, elements=[_measure_sphere()], mode="device")
        assert res.tri_flux is None
        with pytest.raises(ValueError):
            tr.get_surface_flux()

    def test_sphere_uniform_irradiance(self):
        """Isotropic point source centered in a measure sphere: the flux
        map must total exactly the emitted power, and the area-weighted
        irradiance must match P / (4 pi r^2) up to facet-chord area error
        (facets underestimate the sphere area, so irradiance reads high
        by the same ~1% factor)."""
        r = 2.0
        tr = Tracer(TraceConfig(flux_map=True, trace_iterations=3))
        ls = light_source(center=(0, 0, 0), direction=(0, 0, 1), power=1.0,
                          ray_count=20000, seed=1, polar_max=np.pi)
        res = tr.trace(ls, elements=[_measure_sphere(r)], mode="device")
        assert res.tri_flux is not None
        # every emitted ray arrives exactly once: flux total == emitted
        np.testing.assert_allclose(res.tri_flux.sum(),
                                   res.ledger["emitted"], rtol=1e-6)
        sf = tr.get_surface_flux()
        mean_irr = sf["flux"].sum() / sf["area"].sum()
        expected = 1.0 / (4 * np.pi * r * r)
        assert abs(mean_irr - expected) / expected < 0.03
        # per-element totals aggregate the same numbers
        assert abs(sum(sf["per_element"].values()) - 1.0) < 1e-6

    def test_lens_double_counts_by_design(self):
        """A ray passing through a lens deposits its arriving power on
        BOTH faces (flux map, not conservation): total facet flux on the
        lens exceeds the power that entered it once."""
        els = [
            oe.biconvex_lens(1.0, 0.6, 0.12, ior=1.5, center=(0, 0, 1.0)),
            oe.hemisphere(10.0, name="dome"),
        ]
        src = CollimatedSource(center=(0, 0, 0), direction=(0, 0, 1),
                               diameter=0.5, ray_count=4096, power=1.0,
                               seed=2)
        tr = Tracer(TraceConfig(flux_map=True, trace_iterations=6))
        res = tr.trace(src, elements=els, mode="device")
        sf = tr.get_surface_flux()
        lens_flux = list(sf["per_element"].values())[0]
        # every source ray crosses two lens faces; Fresnel losses make the
        # second-face arrival < 1, but the sum must exceed one pass
        assert lens_flux > 1.0
        assert lens_flux < 2.0
        # the detector's facet flux equals its measured power: arrivals at
        # a measure surface are exactly the measured rays
        dome_flux = list(sf["per_element"].values())[1]
        np.testing.assert_allclose(dome_flux, res.ledger["measured"],
                                   rtol=1e-5)

    def test_absorbing_slab_exit_face_attenuated(self):
        """flux_map must deposit the ARRIVING power (post Beer-Lambert
        bulk attenuation): a slab's exit face sees (1-R0) e^{-kL}, not
        the un-attenuated (1-R0) (ADVICE r3 finding)."""
        n, k, L_th = 1.5, 2.0, 0.3
        R0 = ((n - 1) / (n + 1)) ** 2
        slab = oe.cube((2.0, 2.0, L_th), center=(0, 0, L_th / 2),
                       material="refractive", ior=n)
        slab.absorption = k
        els = [slab,
               oe.rectangle(4, 4, center=(0, 0, 5.0), material="measure")]
        src = CollimatedSource(center=(0, 0, -1), direction=(0, 0, 1),
                               diameter=0.5, ray_count=400, power=1.0,
                               seed=4)
        tr = Tracer(TraceConfig(flux_map=True, trace_iterations=6))
        tr.trace(src, elements=els, mode="device", capacity=4096)
        sf = tr.get_surface_flux()
        exit_face = np.abs(sf["centroid"][:, 2] - L_th) < 1e-6
        direct = (1 - R0) * np.exp(-k * L_th)
        assert sf["flux"][exit_face].sum() == pytest.approx(direct,
                                                            rel=0.02)
        # front face: the full beam (1.0) plus the internally-reflected
        # return, itself attenuated over its 2L round trip
        front = np.abs(sf["centroid"][:, 2]) < 1e-6
        expect_front = 1.0 + R0 * (1 - R0) * np.exp(-2 * k * L_th)
        assert sf["flux"][front].sum() == pytest.approx(expect_front,
                                                        rel=0.02)

    def test_multichip_matches_device(self):
        """The psum'd per-shard flux maps must equal the single-device map
        exactly (same scatter adds, reassociated)."""
        els = [
            oe.parabolic_mirror(0.5, 2.0, reflectivity=0.9),
            oe.hemisphere(10.0, name="dome"),
        ]
        src = CollimatedSource(center=(0, 0, 3), direction=(0, 0, -1),
                               diameter=1.5, ray_count=2048, power=1.0,
                               seed=3)
        cfg = TraceConfig(flux_map=True, trace_iterations=6)
        tr = Tracer(cfg)
        res_dev = tr.trace(src, elements=els, mode="device")
        res_mc = tr.trace(src, elements=els, mode="multichip")
        np.testing.assert_allclose(res_mc.tri_flux, res_dev.tri_flux,
                                   rtol=1e-5, atol=1e-9)

    def test_mesh2d_refused(self):
        from lightpycl_tpu.parallel.mesh2d import make_mesh2d

        tr = Tracer(TraceConfig(flux_map=True, trace_iterations=2))
        ls = light_source(center=(0, 0, 0), direction=(0, 0, 1), power=1.0,
                          ray_count=256, seed=0, polar_max=np.pi)
        with pytest.raises(ValueError, match="flux_map"):
            tr.trace(ls, elements=[_measure_sphere()], mode="mesh2d",
                     mesh=make_mesh2d(2, 4))

    def test_volume_events_refused(self):
        glass = oe.cube(1.0, center=(0, 0, 1.0))
        glass.material = Material.REFRACTIVE
        glass.ior = 1.5
        glass.scattering = 5.0  # turbid
        tr = Tracer(TraceConfig(flux_map=True, trace_iterations=2))
        ls = light_source(center=(0, 0, 0), direction=(0, 0, 1), power=1.0,
                          ray_count=64, seed=0)
        with pytest.raises(ValueError, match="flux_map"):
            tr.trace(ls, elements=[glass, oe.hemisphere(10.0)],
                     mode="device")

    def test_spectral_composes(self):
        """flux_map now composes with spectral traces: the per-facet map
        is wavelength-integrated, so a spectral trace's flux map must
        total the emitted power exactly like the
        scalar one — on BOTH execution methods — with the per-lambda
        ledger still closing per column."""
        ls = light_source(center=(0, 0, 0), direction=(0, 0, 1), power=1.0,
                          ray_count=512, seed=0, polar_max=np.pi)
        for method in ("shared", "batched"):
            tr = Tracer(TraceConfig(flux_map=True, trace_iterations=2))
            res = tr.trace_spectral(ls, [0.45, 0.55, 0.65],
                                    elements=[_measure_sphere()],
                                    method=method)
            assert res.tri_flux is not None, method
            # every ray arrives once on the enclosing measure sphere
            assert res.tri_flux.sum() == pytest.approx(1.0, abs=2e-5), method
            led = res.spectral_ledger
            acc = (led["measured"] + led["absorbed"] + led["escaped"]
                   + led["culled"])
            np.testing.assert_allclose(acc, led["emitted"], atol=1e-5)

    def test_batched_accumulates_and_resumes(self, tmp_path):
        """trace_batched sums per-batch flux maps in f64 and the
        checkpoint carries them across a resume."""
        els = [_measure_sphere(2.0)]
        src = light_source(center=(0, 0, 0), direction=(0, 0, 1), power=1.0,
                           ray_count=512, seed=4, polar_max=np.pi)
        cfg = dict(flux_map=True, trace_iterations=3)
        tr = Tracer(TraceConfig(**cfg))
        full = tr.trace_batched(src, total_rays=2048, batch_size=512,
                                elements=els, seed=7)
        assert full.tri_flux is not None
        np.testing.assert_allclose(full.tri_flux.sum(),
                                   full.ledger["emitted"], rtol=1e-6)

        ck = str(tmp_path / "flux_ck")
        tr2 = Tracer(TraceConfig(**cfg))
        tr2.trace_batched(src, total_rays=2048, batch_size=512,
                          elements=els, seed=7, checkpoint_path=ck,
                          max_batches=2)
        resumed = tr2.trace_batched(src, total_rays=2048, batch_size=512,
                                    elements=els, seed=7,
                                    checkpoint_path=ck)
        np.testing.assert_allclose(resumed.tri_flux, full.tri_flux,
                                   rtol=1e-6, atol=1e-12)


class TestSurfaceFluxAnalysis:
    def test_areas_and_centroids(self):
        """surface_flux geometry columns agree with the element mesh."""
        cube = oe.cube(2.0, center=(0, 0, 0))
        cube.material = Material.MEASURE
        tr = Tracer(TraceConfig(flux_map=True, trace_iterations=2))
        ls = light_source(center=(0, 0, 0), direction=(0, 0, 1), power=1.0,
                          ray_count=512, seed=5, polar_max=np.pi)
        tr.trace(ls, elements=[cube], mode="device")
        sf = tr.get_surface_flux()
        # 6 faces x 2 triangles, each of area (2^2)/2 = 2
        np.testing.assert_allclose(sf["area"].sum(), 24.0, rtol=1e-6)
        assert sf["centroid"].shape == (len(sf["area"]), 3)
        # facets span all six faces: max |centroid| coordinate == 2/3 off
        # the face plane at 1 -> within the cube
        assert np.all(np.abs(sf["centroid"]) <= 1.0 + 1e-6)

    def test_plot_smoke(self, tmp_path):
        import matplotlib

        matplotlib.use("Agg")
        tr = Tracer(TraceConfig(flux_map=True, trace_iterations=2))
        ls = light_source(center=(0, 0, 0), direction=(0, 0, 1), power=1.0,
                          ray_count=512, seed=6, polar_max=np.pi)
        res = tr.trace(ls, elements=[_measure_sphere()], mode="device")
        out = str(tmp_path / "flux.png")
        analysis.plot_surface_flux(res.tri_flux, tr.scene, path=out)
        import os

        assert os.path.exists(out)
