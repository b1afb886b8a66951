"""Analytic (exact quadric) optical surfaces.

Extension over the reference (SURVEY.md's upstream is triangle-mesh only:
every curved surface is tessellated, so ray accuracy is facet-limited —
the repo's Coddington/Strehl negative results in ROADMAP.md all trace
back to facet cone blur). An `AnalyticSurface` is intersected EXACTLY on
device instead: conic sections (sphere / paraboloid / ellipsoid /
hyperboloid / plane, the classic sequential-ray-tracer surface model) and
cylinder side walls, bounded by radial and axial aperture limits.

Design: every analytic surface is one row of the ordinary
per-triangle attribute tables — it flows through `build_scene` like any
GeoObject, carrying the FULL material model (coatings, polarization,
dispersion, metals, gratings, detectors...) with zero new physics code.
Its placeholder triangle gets all-zero unit-transform rows, the same
mechanism scene padding uses, so the Pallas kernel can never hit it; the
exact quadric intersection runs as a tiny fused VPU epilogue
(`ops/quadric.py`) merged with the triangle nearest-hit in
`tracer/step.py::trace_step`.

Surface equation, in the surface's LOCAL frame (x_local = frame @
(x_world - vertex)), unified over all supported kinds:

    alpha (x^2 + y^2) + beta z^2 + gamma z + delta = 0

  conic cap   alpha = c, beta = c (1 + k), gamma = -2, delta = 0
              (curvature c = 1/R, conic constant k; c = 0 is a plane)
  cylinder    alpha = 1, beta = 0, gamma = 0, delta = -R^2

bounded by r in [r_min, r_max] and z in [z_lo, z_hi]. The gamma = -2
normalization for conics is an invariant the intersector's docs rely on.

Orientation convention: the element BODY (glass / mirror backing) lies on
the +z_local side of a conic cap, so the outward normal at the vertex is
-z_local — factories orient frames so outward normals match the mesh
primitives' CCW-winding convention (geometry/primitives.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from lightpycl_tpu.geometry.mesh import GeoObject, rotation_matrix

__all__ = [
    "AnalyticSurface", "conic_surface", "cylinder_surface",
    "analytic_lens", "analytic_plano_convex_lens", "analytic_biconvex_lens",
    "analytic_mirror", "analytic_disc", "analytic_annulus",
    "analytic_sphere",
]


def _conic_sag(c: float, k: float, r: float) -> float:
    """Conic sag z(r) = c r^2 / (1 + sqrt(1 - (1+k) c^2 r^2))."""
    if c == 0.0:
        return 0.0
    u = 1.0 - (1.0 + k) * c * c * r * r
    if -1e-9 < u < 0.0:
        u = 0.0  # hemispherical cap: r_max == R rounds to -eps
    if u < 0.0:
        raise ValueError(
            f"aperture radius {r} beyond the conic surface's radial limit "
            f"(1 - (1+k) c^2 r^2 = {u:.3g} < 0)")
    return c * r * r / (1.0 + np.sqrt(u))


def _frame_from_axis(axis) -> np.ndarray:
    """Right-handed orthonormal frame rows (x, y, z_local) in world coords
    with z_local along `axis`."""
    z = np.asarray(axis, np.float64)
    z = z / np.linalg.norm(z)
    h = np.array([1.0, 0.0, 0.0]) if abs(z[0]) < 0.9 else np.array(
        [0.0, 1.0, 0.0])
    x = np.cross(h, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z])


def _placeholder_triangle(vertex: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """A tiny valid triangle parked at the surface vertex. Physics never
    sees it (build_scene zeroes its transform rows, exactly like padding)
    — it only anchors the attribute row and the Morton/cull locality."""
    v = np.asarray(vertex, np.float64)
    verts = np.stack([v, v + (1e-6, 0, 0), v + (0, 1e-6, 0)])
    return verts, np.array([[0, 1, 2]], np.int32)


@dataclasses.dataclass
class AnalyticSurface(GeoObject):
    """One exactly-intersected quadric surface.

    Subclasses GeoObject so it flows through build_scene / the engine /
    the oracle with the full material-attribute surface; the `vertices`/
    `triangles` are a one-triangle placeholder (see module docstring).

    quad_abgd:   (4,) (alpha, beta, gamma, delta) — local implicit form
    quad_rlim:   (2,) radial bounds [r_min, r_max] on hits
    quad_zlim:   (2,) axial bounds [z_lo, z_hi] on hits (local frame)
    quad_vertex: (3,) world position of the local-frame origin
    quad_frame:  (3,3) rows = local x/y/z axes in world coordinates
    """
    quad_abgd: np.ndarray = None
    quad_rlim: np.ndarray = None
    quad_zlim: np.ndarray = None
    quad_vertex: np.ndarray = None
    quad_frame: np.ndarray = None

    # -- rigid transforms keep the analytic frame in sync -----------------

    def translate(self, offset) -> "AnalyticSurface":
        super().translate(offset)
        self.quad_vertex = self.quad_vertex + np.asarray(offset, np.float64)
        return self

    def rotate(self, axis, angle: float,
               pivot=(0.0, 0.0, 0.0)) -> "AnalyticSurface":
        R = rotation_matrix(axis, angle)
        super().rotate(axis, angle, pivot)
        pivot = np.asarray(pivot, np.float64)
        self.quad_vertex = R @ (self.quad_vertex - pivot) + pivot
        self.quad_frame = self.quad_frame @ R.T
        return self

    def scale(self, factor) -> "AnalyticSurface":
        f = np.asarray(factor, np.float64)
        if f.ndim == 0:
            f = np.full(3, float(f))
        if not np.allclose(f, f[0]) or f[0] <= 0:
            raise ValueError("analytic surfaces support UNIFORM positive "
                             "scaling only (a shear/reflection would leave "
                             "the quadric family)")
        s = float(f[0])
        super().scale(s)
        self.quad_vertex = self.quad_vertex * s
        a, b, g, d = self.quad_abgd
        # x -> s x scales each term by its degree: renormalize so conics
        # keep gamma = -2 (alpha' = alpha/s) and cylinders keep alpha = 1
        # (delta' = delta s^2 i.e. R' = R s)
        if g != 0.0:
            self.quad_abgd = np.array([a / s, b / s, g, d * s])
        else:
            self.quad_abgd = np.array([a, b * 1.0, g * s, d * s * s])
        self.quad_rlim = self.quad_rlim * s
        self.quad_zlim = self.quad_zlim * s
        return self

    def transformed(self, matrix: np.ndarray,
                    offset=(0.0, 0.0, 0.0)) -> "AnalyticSurface":
        m = np.asarray(matrix, np.float64)
        s2 = float((m @ m.T)[0, 0])
        if not np.allclose(m @ m.T, np.eye(3) * s2) or np.linalg.det(m) < 0:
            raise ValueError("analytic surfaces support rigid/uniformly-"
                             "scaled proper transforms only")
        s = np.sqrt(s2)
        out = self.copy()
        out.scale(s)
        R = m / s
        out.vertices = out.vertices @ R.T
        out.quad_vertex = R @ out.quad_vertex
        out.quad_frame = out.quad_frame @ R.T
        out.translate(offset)
        if out.axis is not None:
            out.axis = R @ self.axis
        return out

    def copy(self) -> "AnalyticSurface":
        out = super().copy()
        for f in ("quad_abgd", "quad_rlim", "quad_zlim", "quad_vertex",
                  "quad_frame"):
            setattr(out, f, np.array(getattr(self, f), np.float64))
        return out

    # -- visualization / export -------------------------------------------

    def to_mesh(self, n_segments: int = 64, n_radial: int = 24) -> GeoObject:
        """Tessellate for DXF/plot export (NOT used for tracing)."""
        from lightpycl_tpu.geometry.primitives import revolve_profile

        a, b, g, d = self.quad_abgd
        if g != 0.0:  # conic cap
            c = a
            k = (b / a - 1.0) if a != 0.0 else 0.0
            rr = np.linspace(self.quad_rlim[0], self.quad_rlim[1],
                             n_radial + 1)
            prof = np.stack([rr, [_conic_sag(c, k, r) for r in rr]], axis=1)
        else:  # cylinder wall
            R = float(np.sqrt(-d))
            prof = np.array([[R, self.quad_zlim[0]], [R, self.quad_zlim[1]]])
        V, T = revolve_profile(prof[::-1], n_segments)
        mesh = GeoObject(V, T, self.material, self.ior,
                         reflectivity=self.reflectivity, name=self.name)
        return mesh.transformed(self.quad_frame.T, self.quad_vertex)


def _make_surface(abgd, rlim, zlim, vertex, axis, material, ior,
                  **kw) -> AnalyticSurface:
    vertex = np.asarray(vertex, np.float64)
    frame = _frame_from_axis(axis)
    verts, tris = _placeholder_triangle(vertex)
    return AnalyticSurface(
        vertices=verts, triangles=tris,
        material=material, ior=float(ior),
        quad_abgd=np.asarray(abgd, np.float64),
        quad_rlim=np.asarray(rlim, np.float64),
        quad_zlim=np.asarray(zlim, np.float64),
        quad_vertex=vertex, quad_frame=frame, **kw)


def conic_surface(c: float, k: float = 0.0, *, r_max: float,
                  r_min: float = 0.0, vertex=(0, 0, 0), axis=(0, 0, 1),
                  material="refractive", ior: float = 1.5,
                  **kw) -> AnalyticSurface:
    """Conic cap z(r) = c r^2 / (1 + sqrt(1 - (1+k) c^2 r^2)) in the local
    frame whose +z is `axis`; hits accepted for r in [r_min, r_max].

    The element body lies on the +z_local side (outward normal at the
    vertex is -axis) — flip `axis` for the other orientation. c = 0 with
    r_min > 0 is an annular plane (aperture stop); c = 0, r_min = 0 a disc.
    """
    if r_min < 0 or r_max <= r_min:
        raise ValueError("need 0 <= r_min < r_max")
    sags = [_conic_sag(c, k, r_min), _conic_sag(c, k, r_max)]
    zlim = (min(0.0, *sags), max(0.0, *sags))
    return _make_surface((c, c * (1.0 + k), -2.0, 0.0), (r_min, r_max),
                         zlim, vertex, axis, material, ior, **kw)


def cylinder_surface(radius: float, z_lo: float, z_hi: float, *,
                     vertex=(0, 0, 0), axis=(0, 0, 1),
                     material="refractive", ior: float = 1.5,
                     **kw) -> AnalyticSurface:
    """Cylinder side wall x^2 + y^2 = radius^2, z in [z_lo, z_hi] (local).
    Outward normal points away from the axis (body inside)."""
    if radius <= 0 or z_hi <= z_lo:
        raise ValueError("need radius > 0 and z_hi > z_lo")
    return _make_surface((1.0, 0.0, 0.0, -radius * radius),
                         (0.0, 2.0 * radius), (z_lo, z_hi),
                         vertex, axis, material, ior, **kw)


def _curv(r) -> float:
    """Signed curvature from a lensmaker-convention radius (None/inf=flat)."""
    if r is None or np.isinf(r):
        return 0.0
    return 1.0 / float(r)


def analytic_lens(r1, r2, aperture: float, thickness: float,
                  ior: float = 1.5, *, k1: float = 0.0, k2: float = 0.0,
                  center=(0, 0, 0), **kw) -> list[AnalyticSurface]:
    """Exact-conic singlet: same signature and lensmaker sign convention as
    `OpticalElements.spherical_lens` (geometry/primitives.py:308) but the
    two caps intersect analytically; the rim is an exact glass cylinder.
    Returns [front, back, rim] — pass the list into the scene like any
    elements (they share ior/coatings/etc. from **kw).
    """
    a = aperture / 2.0
    c1, c2 = _curv(r1), _curv(r2)
    s1, s2 = _conic_sag(c1, k1, a), _conic_sag(c2, k2, a)
    z_rim_lo, z_rim_hi = s1, thickness + s2
    if z_rim_hi < z_rim_lo - 1e-12:
        raise ValueError("lens surfaces intersect: increase thickness")
    # front cap: +z_local = +z world (glass behind), local c = c1
    front = conic_surface(c1, k1, r_max=a, vertex=(0, 0, 0), axis=(0, 0, 1),
                          material="refractive", ior=ior, **kw)
    # back cap: +z_local = -z world (glass at +z_local), local c = -c2
    back = conic_surface(-c2, k2, r_max=a, vertex=(0, 0, thickness),
                         axis=(0, 0, -1), material="refractive", ior=ior,
                         **kw)
    out = [front, back]
    if z_rim_hi > z_rim_lo + 1e-12:
        # rim wall local frame z = world z (so z range maps directly)
        out.append(cylinder_surface(a, z_rim_lo, z_rim_hi,
                                    vertex=(0, 0, 0), axis=(0, 0, 1),
                                    material="refractive", ior=ior, **kw))
    return [s.translate(center) for s in out]


def analytic_plano_convex_lens(r: float, aperture: float, thickness: float,
                               ior: float = 1.5, **kw):
    """Flat front, convex back (r2 = -r): mirrors plano_convex_lens."""
    return analytic_lens(None, -abs(r), aperture, thickness, ior, **kw)


def analytic_biconvex_lens(r: float, aperture: float, thickness: float,
                           ior: float = 1.5, **kw):
    return analytic_lens(abs(r), -abs(r), aperture, thickness, ior, **kw)


def analytic_mirror(r, diameter: float, *, k: float = 0.0,
                    reflectivity: float = 0.98, center=(0, 0, 0),
                    **kw) -> AnalyticSurface:
    """Conic mirror, dish opening toward +z like the mesh primitives
    (`spherical_mirror`: r > 0 concave toward +z, paraxial focus r/2;
    k = -1 with r = 2*focus is the exact paraboloid of
    `OpticalElements.parabolic_mirror`). Reflective face up: outward
    normal +z at the vertex, so the local frame is flipped (z_local =
    -z_world, c_local = -1/r)."""
    m = conic_surface(-_curv(r), k, r_max=diameter / 2.0, vertex=(0, 0, 0),
                      axis=(0, 0, -1), material="mirror", ior=1.0,
                      reflectivity=reflectivity, **kw)
    return m.translate(center)


def analytic_disc(radius: float, *, vertex=(0, 0, 0), axis=(0, 0, 1),
                  material="measure", **kw) -> AnalyticSurface:
    """Exact plane disc (detector/absorber/mirror). Outward normal -axis."""
    return conic_surface(0.0, 0.0, r_max=radius, vertex=vertex, axis=axis,
                         material=material, ior=1.0, **kw)


def analytic_annulus(r_min: float, r_max: float, *, vertex=(0, 0, 0),
                     axis=(0, 0, 1), material="terminator",
                     **kw) -> AnalyticSurface:
    """Exact plane annulus — the classic aperture stop."""
    return conic_surface(0.0, 0.0, r_max=r_max, r_min=r_min, vertex=vertex,
                         axis=axis, material=material, ior=1.0, **kw)


def analytic_sphere(radius: float, *, center=(0, 0, 0), material="measure",
                    ior: float = 1.0, **kw) -> list[AnalyticSurface]:
    """Exact full sphere as two hemispherical caps (e.g. a detector dome).
    Outward normals point away from the center."""
    c = np.asarray(center, np.float64)
    lo = conic_surface(1.0 / radius, 0.0, r_max=radius,
                       vertex=c - (0, 0, radius), axis=(0, 0, 1),
                       material=material, ior=ior, **kw)
    hi = conic_surface(1.0 / radius, 0.0, r_max=radius,
                       vertex=c + (0, 0, radius), axis=(0, 0, -1),
                       material=material, ior=ior, **kw)
    return [lo, hi]
