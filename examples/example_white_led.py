"""Phosphor-converted white LED: fluorescence + colorimetry.

A blue (450 nm) die pumps a YAG:Ce-like phosphor plate
(GeoObject(fluorescence=mu_f, fluor_emission=(mean, fwhm))). Conversion
events follow Exp(mu_f) free paths below the absorption edge; each
converted photon re-emits isotropically in the yellow band, keeping
quantum yield x Stokes-shift of its power. The blue that leaks through
plus the yellow that converts is what makes every white LED white — and
the phosphor loading mu_f is the knob that tunes the correlated color
temperature (CCT) from cool to warm.

Anchors: the surviving pump obeys e^{-mu_f L} exactly; each chromaticity
lands on the blue-yellow mixing line; CCT falls monotonically with
phosphor loading; power conserved to ~1e-5 in every run.

    JAX_PLATFORMS=cpu python examples/example_white_led.py
"""

import os

import numpy as np

from lightpycl_tpu import analysis, optical_elements
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu.tracer.engine import Tracer
from lightpycl_tpu.utils import setup_logging

setup_logging()

RAY_COUNT = int(os.environ.get("RAY_COUNT", 20_000))
PUMP_UM = 0.450
PHOSPHOR_BAND = (0.57, 0.10)   # YAG:Ce-ish yellow: mean / fwhm [um]
QY = 0.95
L_PLATE = 0.5


def build(mu_f):
    oe = optical_elements()
    plate = oe.cube((4.0, 4.0, L_PLATE), center=(0, 0, 0.5 + L_PLATE / 2),
                    material="refractive", ior=1.0,   # index-matched encap
                    fluorescence=mu_f, fluor_yield=QY,
                    fluor_emission=PHOSPHOR_BAND, fluor_edge=0.50)
    world = oe.sphere(radius=25.0, material="measure", name="world")
    return [plate, world]


die = CollimatedSource(center=(0, 0, 0), direction=(0, 0, 1),
                       diameter=1.0, power=1.0, ray_count=RAY_COUNT,
                       wavelength=PUMP_UM)

print(f"blue die {PUMP_UM * 1e3:.0f} nm -> phosphor plate "
      f"(band {PHOSPHOR_BAND[0] * 1e3:.0f}/{PHOSPHOR_BAND[1] * 1e3:.0f} nm "
      f"fwhm, QY {QY})")
ccts, xs, ys = [], [], []
for mu_f in (2.0, 3.0, 4.5):
    res = Tracer().trace(die, build(mu_f), trace_iterations=14,
                         capacity=4 * RAY_COUNT)
    err = res.power_conservation_error()
    wl, pw = res.measured_wavelength, res.measured_power
    # the unconverted pump keeps its exact wavelength; the emission
    # band's blue tail (down to ~0.46 um) must not be counted as pump
    blue = pw[np.abs(wl - PUMP_UM) < 1e-4].sum()
    x, y = analysis.chromaticity(wl, pw)
    t_cct = analysis.cct(x, y)
    r, g, b = analysis.srgb(wl, pw)
    ccts.append(t_cct)
    xs.append(x)
    ys.append(y)
    want_blue = np.exp(-mu_f * L_PLATE)
    print(f"  mu_f = {mu_f:3.1f}: pump survives {blue:.3f} "
          f"(Beer-Lambert {want_blue:.3f}), (x, y) = ({x:.3f}, {y:.3f}), "
          f"CCT = {t_cct:6.0f} K, sRGB = ({r:.2f}, {g:.2f}, {b:.2f}), "
          f"conservation err {err:.1e}")
    assert err < 1e-4
    assert abs(blue - want_blue) < 0.05 * want_blue + 5e-3

print("thicker phosphor -> warmer white (CCT falls): "
      f"{' > '.join(f'{t:.0f}K' for t in ccts)}")
# more conversion moves the mix along the blue->yellow mixing line
# (x and y both rise) and the correlated color temperature falls
# (McCamy is only meaningful near the locus, which these loadings are)
assert xs[0] < xs[1] < xs[2] and ys[0] < ys[1] < ys[2]
assert ccts[0] > ccts[1] > ccts[2]
