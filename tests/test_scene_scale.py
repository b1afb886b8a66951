"""Telescope-scale scene robustness (r5): the max_ray_len auto-horizon
and the f32 relaunch push.

Anchors:
- a mirror 1500 units from the source conserves power end-to-end (both
  fixes together: without the horizon expansion every ray escaped at
  the default 1e3; without the push 6% of the reflected power
  self-re-hit the facet and was lost);
- the auto-expansion is expand-only, power-of-two, and never touches an
  explicitly set max_ray_len;
- small scenes resolve to the classic default exactly (identical
  compile keys round over round).
"""

import numpy as np
import pytest

import lightpycl_tpu as L
from lightpycl_tpu.sources import CollimatedSource
from lightpycl_tpu.tracer.config import TraceConfig
from lightpycl_tpu.tracer.engine import Tracer

oe = L.optical_elements(n_segments=48, n_radial=24)


def _telescope():
    primary = oe.conic_mirror(r=-2000.0, diameter=200.0, k=-1.0)
    det = oe.disc(radius=8.0, center=(0, 0, -1000.0), material="measure",
                  name="focus")
    return [primary, det]


class TestAutoRayLen:
    def test_small_scene_keeps_default(self):
        tr = Tracer()
        tr.set_elements([oe.sphere(5.0, material="measure")])
        cfg = tr._resolve_ray_len(TraceConfig(),
                                  origins=np.zeros((1, 3)))
        assert cfg.max_ray_len == 1e3  # bit-equal: same jit cache key

    def test_telescope_scene_expands_pow2(self):
        tr = Tracer()
        tr.set_elements(_telescope())
        cfg = tr._resolve_ray_len(
            TraceConfig(), origins=np.array([[0.0, 0.0, -1500.0]]))
        assert cfg.max_ray_len == 4096.0  # 2^ceil(log2(2 * reach))

    def test_explicit_value_respected(self):
        tr = Tracer()
        tr.set_elements(_telescope())
        cfg = tr._resolve_ray_len(
            TraceConfig(max_ray_len=1234.0),
            origins=np.array([[0.0, 0.0, -1500.0]]))
        assert cfg.max_ray_len == 1234.0


class TestTelescopeConservation:
    def test_far_mirror_conserves_power(self):
        """End to end: collimated beam from 1500 units out, parabolic
        mirror, focus detector — measured + absorbed accounts for
        everything (no silent horizon loss, no self-re-hit loss)."""
        src = CollimatedSource(center=(0, 0, -1500.0), direction=(0, 0, 1),
                               diameter=150.0, power=1.0, ray_count=2048,
                               seed=2, sampling="halton")
        res = Tracer(TraceConfig()).trace(src, _telescope(),
                                          trace_iterations=3, capacity=4096)
        # 0.98 reflectivity; the 8-radius detector shadows (8/75)^2 ~ 1.1%
        assert res.ledger["measured"] > 0.96
        assert res.ledger["absorbed"] == pytest.approx(0.02, abs=0.005)
        # the push must not create phantom escapes either
        assert res.ledger["escaped"] < 0.02
        acc = sum(res.ledger[k] for k in ("measured", "absorbed",
                                          "escaped", "culled"))
        assert acc == pytest.approx(1.0, abs=1e-4)
