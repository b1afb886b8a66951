"""Catadioptric .zmx import: a classical Cassegrain telescope.

Round-5 parity wave (SURVEY.md §3 'Examples' / §7 "example scripts port
one-to-one"): telescope prescriptions are the
most common class of real .zmx files, and they exercise everything the
dioptric path does not — MIRROR surfaces with conic terms, negative
thicknesses (the fold), the primary's central hole (sequential files
don't model it; a non-sequential tracer must), and the mirror fold in
the paraxial ABCD layer.

  1. write a classical Cassegrain prescription (parabolic f/2 primary,
     hyperbolic secondary, magnification m = 3) with `save_zmx`-style
     records, including the OBSC record for the primary's hole;
  2. `zmx_paraxial` folds it straight: EFL = f1*m = 300, back focus
     (secondary -> image, along the path) = 120;
  3. `zmx_to_scene` builds conic mirrors (`conic_mirror` primitive,
     hole honored) + the image-plane measure disc at z = +60 (behind
     the primary, lab frame);
  4. trace a collimated star: detected power matches the annulus area
     x two 0.98 reflections, and the traced best focus lands on the
     paraxial image plane.

    JAX_PLATFORMS=cpu python examples/example_cassegrain.py
"""

import os
import tempfile

import numpy as np

from lightpycl_tpu.analysis import best_focus
from lightpycl_tpu.io import load_zmx, zmx_paraxial, zmx_to_scene
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu.tracer.config import TraceConfig
from lightpycl_tpu.tracer.engine import Tracer
from lightpycl_tpu.utils import setup_logging

setup_logging()

RAY_COUNT = int(os.environ.get("RAY_COUNT", 20_000))

# ------------------------------------------------------------ prescription
# Classical Cassegrain, all Zemax sign conventions: R < 0 = concave
# toward the incoming +z light; thickness after a mirror is negative
# (light folds back). Primary f1 = 100 (R = -200, k = -1); secondary 60
# before it, magnification m = 3: virtual object s = f1 - d = 40,
# image s' = m s = 120 -> f2 = s s'/(s - s') = -60, R2 = 2 f2 = -120,
# k2 = -((m+1)/(m-1))^2 = -4. Image lands 60 behind the primary vertex.
ZMX = "\n".join([
    "MODE SEQ", "NAME classical cassegrain m=3",
    "UNIT MM X W X CM MR CPMM", "WAVM 1 0.5876 1", "PWAV 1",
    "SURF 0", "  TYPE STANDARD", "  DISZ INFINITY",
    "SURF 1", "  TYPE STANDARD", "  COMM primary", "  CURV -0.005",
    "  CONI -1", "  DISZ -60", "  GLAS MIRROR",
    "  DIAM 25 1 0 0 1 \"\"", "  OBSC 0 9",
    "SURF 2", "  TYPE STANDARD", "  COMM secondary",
    f"  CURV {-1.0 / 120.0:.17g}", "  CONI -4",
    "  DISZ 120", "  GLAS MIRROR", "  DIAM 11 1 0 0 1 \"\"",
    "SURF 3", "  TYPE STANDARD", "  DISZ 0", "  DIAM 2 1 0 0 1 \"\"",
])

path = os.path.join(tempfile.mkdtemp(), "cassegrain.zmx")
with open(path, "w") as f:
    f.write(ZMX)

presc = load_zmx(path)
props = zmx_paraxial(presc)
print(f"paraxial fold: EFL={props['efl']:.3f}  "
      f"back focus (along path)={props['bfd']:.3f}")
assert abs(props["efl"] - 300.0) < 1e-9
assert abs(props["bfd"] - 120.0) < 1e-9

elements, info = zmx_to_scene(path, n_segments=256, n_radial=96,
                              detector_scale=5.0)
print("elements:", [e.name for e in elements])
print("lab-frame image plane z =", info["z_image"])
for w in info["warnings"]:
    print("note:", w)

src = CollimatedSource(center=(0.0, 0.0, -150.0), direction=(0, 0, 1),
                       diameter=50.0, power=1.0, ray_count=RAY_COUNT,
                       seed=5, sampling="halton")
res = Tracer(TraceConfig()).trace(src, elements, trace_iterations=4,
                                  capacity=4 * RAY_COUNT)
print("ledger:", {k: round(v, 4) for k, v in res.ledger.items()})

fwd = np.asarray(res.measured_dir[:, 2]) > 0.5  # beam through the hole
w = np.asarray(res.measured_power)[fwd]
frac = 1.0 - (11.0 / 25.0) ** 2  # secondary obscuration annulus
expect = frac * 0.98**2
print(f"detected power: {w.sum():.4f} (expect ~{expect:.4f}: "
      "annulus area x two 0.98 mirrors)")

z_best, rms = best_focus(np.asarray(res.measured_pos)[fwd],
                         np.asarray(res.measured_dir)[fwd], w,
                         z_range=(info["z_image"] - 20.0,
                                  info["z_image"] + 20.0))
print(f"traced best focus z={z_best:.2f} (paraxial {info['z_image']:.2f}), "
      f"rms spot {rms:.3f}")
assert abs(z_best - info["z_image"]) < 2.0
assert w.sum() > 0.9 * expect
print("ok: Cassegrain .zmx imports, folds, and traces to the paraxial focus")
