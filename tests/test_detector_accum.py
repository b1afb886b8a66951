"""Detector accumulation (step.accumulate_detector_arrays) against float64
numpy bincounts.

Every detector surface accumulates by XLA scatter-add. On the GPU that is
atomic adds, whose order changes from run to run, so sums there are equal
to f32 reassociation (~1e-6 relative), not bit for bit; here they are held
to 1e-5 relative against float64 sums. Inputs sit at bin centres so the
expected bin of every ray is known exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import lightpycl_tpu as L
from lightpycl_tpu.sources import CollimatedSource, _frame
from lightpycl_tpu.tracer.config import TraceConfig
from lightpycl_tpu.tracer.engine import Tracer
from lightpycl_tpu.tracer.rays import DetectorState
from lightpycl_tpu.tracer.step import accumulate_detector_arrays

N_AZ, N_POL, N_DET, NB, NT = 36, 18, 3, 8, 5
HW = 1.0                       # image half-width, centred on the origin
OPL_MIN, OPL_MAX = 0.0, 10.0
WL = 0.5


def _batch(rng, C, out_of_range=False):
    """Rays at bin centres: hit points on the unit sphere at angular bin
    centres (hist_mode='position'), image pixels at pixel centres of the
    z = 0 image plane, OPL at time-bin centres."""
    ia = rng.integers(0, N_AZ, C)
    ip = rng.integers(0, N_POL, C)
    az = (ia + 0.5) / N_AZ * 2 * np.pi
    pol = (ip + 0.5) / N_POL * np.pi
    sph = np.stack([np.sin(pol) * np.cos(az), np.sin(pol) * np.sin(az),
                    np.cos(pol)], 1)
    ix = rng.integers(0, NB, C)
    iy = rng.integers(0, NB, C)
    px = (ix + 0.5) / NB * 2 * HW - HW
    py = (iy + 0.5) / NB * 2 * HW - HW
    it = rng.integers(0, NT, C)
    opl = OPL_MIN + (it + 0.5) / NT * (OPL_MAX - OPL_MIN)
    det = rng.integers(0, N_DET, C)
    power = rng.uniform(0.0, 1e-3, C)
    power[rng.uniform(size=C) < 0.2] = 0.0       # unmeasured slots
    if out_of_range:
        far = rng.uniform(size=C) < 0.3
        px = np.where(far, 5 * HW, px)             # outside the image
        det = np.where(rng.uniform(size=C) < 0.3, N_DET + 4, det)
        late = rng.uniform(size=C) < 0.3
        opl = np.where(late, 3 * OPL_MAX, opl)     # clamps to the last bin
        it = np.where(late, NT - 1, it)
    return dict(ia=ia, ip=ip, sph=sph, ix=ix, iy=iy, px=px, py=py, it=it,
                opl=opl, det=det, power=power)


def _accumulate(b, coherent=False):
    C = len(b["power"])
    # the hist bins the sphere point and the image the plane point: the
    # two surfaces read different hit points, so run them as two calls
    cfg = TraceConfig(hist_azimuth_bins=N_AZ, hist_polar_bins=N_POL,
                      image_bins=NB, image_halfwidth=HW, time_bins=NT,
                      opl_min=OPL_MIN, opl_max=OPL_MAX, coherent=coherent)
    det0 = DetectorState.zeros(N_AZ, N_POL, N_DET, NB, coherent=coherent,
                               time_bins=NT)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    p = f32(b["power"])
    did = jnp.asarray(b["det"], jnp.int32)
    wl = jnp.full((C,), WL, jnp.float32)
    a = accumulate_detector_arrays(det0, f32(b["sph"]), f32(b["sph"]), p,
                                   did, cfg, opl=f32(b["opl"]),
                                   wavelength=wl)
    F = _frame(cfg.image_normal)       # image (u, v) axes in the world
    img_pts = b["px"][:, None] * F[0] + b["py"][:, None] * F[1]
    i = accumulate_detector_arrays(det0, f32(img_pts), f32(b["sph"]), p,
                                   did, cfg, opl=f32(b["opl"]),
                                   wavelength=wl)
    return a, i


def _close(got, ref):
    scale = max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref,
                               rtol=1e-5, atol=1e-5 * scale)


CASES = ["hist", "per_detector", "image", "time_bins", "coherent", "empty",
         "out_of_range"]


@pytest.mark.parametrize("case", CASES)
def test_scatter_matches_f64_bincount(case):
    rng = np.random.default_rng(CASES.index(case))
    C = 0 if case == "empty" else 20_000
    b = _batch(rng, C, out_of_range=case == "out_of_range")
    a, i = _accumulate(b, coherent=case == "coherent")
    w = b["power"]
    det = np.clip(b["det"], 0, N_DET - 1)
    hist = np.bincount(b["ia"] * N_POL + b["ip"], w, N_AZ * N_POL)
    per = np.bincount(det, w, N_DET)
    inside = np.abs(b["px"]) < HW
    img = np.bincount((b["ix"] * NB + b["iy"])[inside], w[inside], NB * NB)
    tim = np.bincount(det * NT + b["it"], w, N_DET * NT)
    if case in ("hist", "empty", "out_of_range"):
        _close(a.hist.reshape(-1), hist)
    if case in ("per_detector", "empty", "out_of_range"):
        _close(a.per_detector, per)
    if case in ("image", "empty", "out_of_range"):
        _close(i.image.reshape(-1), img)
    if case in ("time_bins", "empty", "out_of_range"):
        _close(a.time_hist.reshape(-1), tim)
        assert float(a.time_hist.sum()) == pytest.approx(w.sum(), rel=1e-5,
                                                         abs=1e-12)
    if case == "coherent":
        turns = b["opl"] / WL
        ph = 2 * np.pi * (turns - np.floor(turns))
        amp = np.sqrt(w)
        idx = b["ix"] * NB + b["iy"]
        _close(i.image_amp[0].reshape(-1),
               np.bincount(idx, amp * np.cos(ph), NB * NB))
        _close(i.image_amp[1].reshape(-1),
               np.bincount(idx, amp * np.sin(ph), NB * NB))
        _close(i.image.reshape(-1), img)
    if case == "empty":
        assert float(a.hist.sum()) == 0.0 and float(i.image.sum()) == 0.0


def test_trace_image_and_detector_account_for_measured_power():
    # every surface sums the same measured power in its own f32 order
    oe = L.optical_elements(n_segments=32, n_radial=12)
    lens = oe.plano_convex_lens(r=0.5, aperture=0.6, thickness=0.1, ior=1.5)
    det = oe.disc(radius=0.5, center=(0, 0, 1.1), material="measure",
                  name="focal")
    src = CollimatedSource(center=(0, 0, -0.5), direction=(0, 0, 1),
                           diameter=0.3, ray_count=2048, power=1.0, seed=4)
    res = Tracer().trace(src, [lens, det], trace_iterations=4,
                         mode="device", image_bins=16,
                         image_center=(0, 0, 1.1), image_halfwidth=0.3,
                         time_bins=8, opl_min=0.0, opl_max=4.0)
    measured = res.ledger["measured"]
    assert res.per_detector.sum() == pytest.approx(measured, rel=1e-4)
    assert res.hist.sum() == pytest.approx(measured, rel=1e-4)
    assert res.time_hist.sum() == pytest.approx(measured, rel=1e-4)
    assert res.image.sum() == pytest.approx(measured, rel=1e-4)
