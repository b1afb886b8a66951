"""lightpycl_tpu — a JAX geometric-optics ray tracer.

A brand-new JAX/XLA/Pallas framework with the capabilities of LightPyCL
(ngchihuan/LightPyCL; see SURVEY.md for the capability inventory): Python
scripted optical benches — light sources with arbitrary directivity, triangle
mesh optical elements (mirrors, dielectric lenses, absorbers, measurement
surfaces) — traced with nearest-hit intersection, Snell refraction, total
internal reflection and Fresnel power-split ray splitting; measurement
surfaces accumulate power; results post-process into directivity plots and
DXF CAD exports.

Architecture (a rebuild, not a port):
  * functional core — scenes/rays are pytrees, the trace step is jitted,
    shapes are static, compaction is an on-device sort, the detector
    histogram is an on-device scatter-add;
  * hot loop — ray x triangle nearest-hit runs on the GPU as a Pallas
    kernel (Triton route) that evaluates per-triangle unit-space affine
    transforms as fp32 FMAs with a running argmin across streamed triangle
    tiles (reference equivalent: kernel_reflect_refract_intersect.cl,
    SURVEY.md §3);
  * scale-out — rays shard over a device mesh with `shard_map`; detector
    bins and power ledgers reduce with `psum`.
"""

from lightpycl_tpu.materials import Material, glass
from lightpycl_tpu.geometry.mesh import (GeoObject, instance_grid, instances,
                                         merge)
from lightpycl_tpu.geometry.primitives import OpticalElements, optical_elements
from lightpycl_tpu.geometry.analytic import (
    AnalyticSurface, analytic_annulus, analytic_biconvex_lens, analytic_disc,
    analytic_lens, analytic_mirror, analytic_plano_convex_lens,
    analytic_sphere, conic_surface, cylinder_surface)
from lightpycl_tpu.sources import AreaSource, LightSource, light_source
from lightpycl_tpu.tracer.config import TraceConfig
from lightpycl_tpu.tracer.scene import Scene, build_scene
from lightpycl_tpu.tracer.rays import RayBatch
from lightpycl_tpu.tracer.engine import Tracer, TraceResult
from lightpycl_tpu.compat import CL_Tracer

__version__ = "0.3.0"

__all__ = [
    "Material",
    "glass",
    "GeoObject",
    "merge",
    "instances",
    "instance_grid",
    "OpticalElements",
    "optical_elements",
    "AnalyticSurface",
    "conic_surface",
    "cylinder_surface",
    "analytic_lens",
    "analytic_plano_convex_lens",
    "analytic_biconvex_lens",
    "analytic_mirror",
    "analytic_disc",
    "analytic_annulus",
    "analytic_sphere",
    "AreaSource",
    "LightSource",
    "light_source",
    "TraceConfig",
    "Scene",
    "build_scene",
    "RayBatch",
    "Tracer",
    "TraceResult",
    "CL_Tracer",
]
