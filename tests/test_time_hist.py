"""Time-resolved detection (TraceConfig.time_bins): measured power binned
by arrival optical path length — the exact time-of-flight histogram
(t = OPL / c). Extension on the reference's L5 analysis; OPL itself is the
round-1 Fermat-tested per-ray accumulator.
"""

import numpy as np
import pytest

import lightpycl_tpu as L
from lightpycl_tpu.materials import Material
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu.tracer.config import TraceConfig
from lightpycl_tpu.tracer.engine import Tracer

oe = L.optical_elements(n_segments=24, n_radial=8)


def _detector_disc(z, radius=2.0, name="det"):
    return oe.disc(radius=radius, center=(0, 0, z),
                   material=Material.MEASURE, name=name)


class TestTimeHist:
    def test_direct_flight_single_bin(self):
        """Collimated rays to a plane at z = L in vacuum arrive with
        OPL exactly L: all measured power lands in one bin."""
        L_det = 5.0
        cfg = TraceConfig(time_bins=16, opl_min=0.0, opl_max=9.6,
                          trace_iterations=3)
        tr = Tracer(cfg)
        src = CollimatedSource(center=(0, 0, 0), direction=(0, 0, 1),
                               diameter=1.0, ray_count=2048, power=1.0,
                               seed=0)
        res = tr.trace(src, elements=[_detector_disc(L_det)], mode="device")
        assert res.time_hist is not None
        assert res.time_hist.shape == (1, 16)
        # bin of OPL=5 in [0, 9.6) over 16 bins: floor(5/9.6*16) = 8
        edges, h = res.detector_time_histogram("det")
        assert edges.shape == (17,)
        np.testing.assert_allclose(h.sum(), res.ledger["measured"],
                                   rtol=1e-5)
        assert h[8] == pytest.approx(res.ledger["measured"], rel=1e-5)
        assert np.all(h[np.arange(16) != 8] == 0)

    def test_glass_slab_delays_arrival(self):
        """A glass slab (thickness h, index n) in the path shifts the
        arrival OPL by exactly (n - 1) * h at normal incidence."""
        L_det, h_slab, n_glass = 5.0, 1.0, 1.5
        # wide slab (scale about the origin leaves the z placement
        # alone) so the whole beam crosses it
        slab = oe.cube(size=1.0, center=(0, 0, 2.0),
                       material=Material.REFRACTIVE,
                       ior=n_glass).scale((4.0, 4.0, 1.0))
        cfg = TraceConfig(time_bins=32, opl_min=4.0, opl_max=6.4,
                          trace_iterations=6)
        tr = Tracer(cfg)
        src = CollimatedSource(center=(0, 0, 0), direction=(0, 0, 1),
                               diameter=1.0, ray_count=2048, power=1.0,
                               seed=1)
        res = tr.trace(src, elements=[slab, _detector_disc(L_det)],
                       mode="device")
        edges, h = res.detector_time_histogram("det")
        # direct OPL would be 5.0; through the slab it is 5.0 + 0.5 = 5.5
        # -> bin floor((5.5-4)/2.4*32) = 20
        expect_bin = int((5.5 - 4.0) / 2.4 * 32)
        peak = int(np.argmax(h))
        assert peak == expect_bin
        # the peak carries the (Fresnel-reduced) transmitted power; the
        # total histogram equals everything measured
        np.testing.assert_allclose(h.sum(), res.ledger["measured"],
                                   rtol=1e-5)

    def test_two_detectors_separate_rows(self):
        """A beamsplitter sends the two children to detectors at different
        path lengths: each detector's histogram peaks in its own bin."""
        bs = oe.rectangle(2.0, 2.0, center=(0, 0, 2.0),
                          material="beamsplitter",
                          reflectivity=0.5).rotate(
            (1, 0, 0), np.pi / 4, pivot=(0, 0, 2.0))
        d_thru = _detector_disc(5.0, name="thru")          # OPL 5
        # reflected arm travels +y; face the detector's normal (-y) at it
        d_side = oe.disc(radius=2.0, material=Material.MEASURE,
                         name="side").rotate(
            (1, 0, 0), np.pi / 2).translate((0, 4.0, 2.0))
        cfg = TraceConfig(time_bins=20, opl_min=0.0, opl_max=8.0,
                          trace_iterations=4)
        tr = Tracer(cfg)
        src = CollimatedSource(center=(0, 0, 0), direction=(0, 0, 1),
                               diameter=0.5, ray_count=1024, power=1.0,
                               seed=2)
        res = tr.trace(src, elements=[bs, d_thru, d_side], mode="device",
                       capacity=4096)  # splitting headroom
        _, h_thru = res.detector_time_histogram("thru")
        _, h_side = res.detector_time_histogram("side")
        assert int(np.argmax(h_thru)) == int(5.0 / 8.0 * 20)   # bin 12
        assert int(np.argmax(h_side)) == int(6.0 / 8.0 * 20)   # bin 15
        # 50/50 split
        np.testing.assert_allclose(h_thru.sum(), 0.5, atol=0.01)
        np.testing.assert_allclose(h_side.sum(), 0.5, atol=0.01)

    def test_out_of_range_clamps_into_edge_bins(self):
        cfg = TraceConfig(time_bins=4, opl_min=0.0, opl_max=1.0,
                          trace_iterations=3)
        tr = Tracer(cfg)
        src = CollimatedSource(center=(0, 0, 0), direction=(0, 0, 1),
                               diameter=1.0, ray_count=512, power=1.0,
                               seed=3)
        res = tr.trace(src, elements=[_detector_disc(5.0)], mode="device")
        _, h = res.detector_time_histogram("det")
        np.testing.assert_allclose(h.sum(), res.ledger["measured"],
                                   rtol=1e-5)
        assert h[-1] == pytest.approx(res.ledger["measured"], rel=1e-5)

    def test_multichip_matches_device(self):
        els = [
            oe.parabolic_mirror(0.5, 2.0, reflectivity=0.9),
            oe.hemisphere(10.0, name="dome"),
        ]
        src = CollimatedSource(center=(0, 0, 3), direction=(0, 0, -1),
                               diameter=1.5, ray_count=2048, power=1.0,
                               seed=4)
        cfg = TraceConfig(time_bins=24, opl_min=0.0, opl_max=30.0,
                          trace_iterations=6)
        tr = Tracer(cfg)
        res_dev = tr.trace(src, elements=els, mode="device")
        res_mc = tr.trace(src, elements=els, mode="multichip")
        # per-shard scatter order differs from the single-device order, so
        # the f32 bin sums drift at the last-ulp scale (observed 2e-5 rel
        # at 2048 rays); the binning itself is identical
        np.testing.assert_allclose(res_mc.time_hist, res_dev.time_hist,
                                   rtol=3e-4, atol=1e-9)
        assert np.array_equal(res_mc.time_hist > 0, res_dev.time_hist > 0)

    def test_batched_accumulates(self):
        from lightpycl_tpu.sources import light_source

        # window chosen so OPL=2 is NOT on a bin edge (2/3.84*8 = 4.17)
        cfg = TraceConfig(time_bins=8, opl_min=0.0, opl_max=3.84,
                          trace_iterations=3)
        tr = Tracer(cfg)
        src = light_source(center=(0, 0, 0), direction=(0, 0, 1), power=1.0,
                           ray_count=512, seed=5, polar_max=np.pi)
        sphere = oe.sphere(radius=2.0)
        sphere.material = Material.MEASURE
        res = tr.trace_batched(src, total_rays=2048, batch_size=512,
                               elements=[sphere], seed=6)
        assert res.time_hist is not None
        np.testing.assert_allclose(res.time_hist.sum(),
                                   res.ledger["measured"], rtol=1e-5)
        # all arrivals at OPL = 2 (sphere radius): bin floor(2/3.84*8) = 4
        assert res.time_hist[0, 4] == pytest.approx(
            res.ledger["measured"], rel=1e-5)

    def test_missing_window_raises(self):
        tr = Tracer(TraceConfig(time_bins=8))
        src = CollimatedSource(center=(0, 0, 0), direction=(0, 0, 1),
                               diameter=1.0, ray_count=64, power=1.0, seed=0)
        with pytest.raises(ValueError, match="opl_max"):
            tr.trace(src, elements=[_detector_disc(5.0)], mode="device")

    def test_not_time_resolved_accessor_raises(self):
        tr = Tracer(TraceConfig(trace_iterations=2))
        src = CollimatedSource(center=(0, 0, 0), direction=(0, 0, 1),
                               diameter=1.0, ray_count=64, power=1.0, seed=0)
        res = tr.trace(src, elements=[_detector_disc(5.0)], mode="device")
        assert res.time_hist is None
        with pytest.raises(ValueError):
            res.detector_time_histogram("det")


class TestSpectralToF:
    """time_bins composes with spectral traces:
    the ToF histogram is wavelength-integrated, deposited inside both
    spectral execution methods with the per-lambda ledger intact."""

    def test_both_methods_single_bin(self):
        L_det = 5.0
        for method in ("shared", "batched"):
            cfg = TraceConfig(time_bins=16, opl_min=0.0, opl_max=9.6,
                              trace_iterations=3)
            tr = Tracer(cfg)
            src = CollimatedSource(center=(0, 0, 0), direction=(0, 0, 1),
                                   diameter=1.0, ray_count=512, power=1.0,
                                   seed=0)
            res = tr.trace_spectral(src, [0.45, 0.55, 0.65],
                                    elements=[_detector_disc(L_det)],
                                    method=method)
            edges, h = res.detector_time_histogram("det")
            assert edges.shape == (17,), method
            # OPL = 5 in [0, 9.6) over 16 bins -> bin 8, total = measured
            np.testing.assert_allclose(h.sum(), res.ledger["measured"],
                                       rtol=5e-5)
            assert h[8] == pytest.approx(res.ledger["measured"],
                                         rel=5e-5), method
            led = res.spectral_ledger
            acc = (led["measured"] + led["absorbed"] + led["escaped"]
                   + led["culled"])
            np.testing.assert_allclose(acc, led["emitted"], atol=1e-5)
