"""Differentiable optical design: end-to-end gradients through the tracer.

The reference (SURVEY.md §1) is a forward simulator only — PyOpenCL kernels
are opaque to autodiff. In this rebuild the whole trace step is a pure
jittable JAX function over pytrees (tracer/step.py), so the gradient of any
scalar figure of merit (spot RMS, detected power, focal error) flows back
through shading (Fresnel powers, Snell directions), intersection (hit
distances), and — with the parametric meshers in this module — the lens
prescription itself (curvatures, thickness). `jax.grad` + optax turn the
tracer into a lens-design optimizer; this capability has no reference
equivalent and is a direct consequence of the functional design.

Differentiation semantics (standard in differentiable ray tracing): the
ray→triangle assignment (argmin) and all material/visibility masks are
treated as locally constant. Smooth parameter changes that slide hit points
and bend refraction angles are differentiated exactly; topology changes (a
ray slipping off the aperture rim, a new TIR onset) show up as kinks. A
tessellated sphere is a piecewise-linear approximation of the smooth
surface, so gradients carry O(1/n_seg^2) facet noise — use enough segments
(>= 32) and a few hundred rays to average it out.

Gradient safety: the production intersectors (tracer/step.py,
ops/intersect_gpu.py) exploit IEEE inf/nan semantics (t = -OW / DW with
DW == 0 on padding rows). Forward that is correct and fast, but reverse-mode
AD of x / 0 manufactures nan cotangents even under a downstream mask
(0 * inf). `intersect_diff` here is the same unit-transform math with a
guarded denominator, keeping every intermediate finite so gradients are
clean. Shade/compact are reused from tracer/step.py unchanged.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lightpycl_tpu.materials import Material
from lightpycl_tpu.tracer.config import TraceConfig
from lightpycl_tpu.tracer.rays import RayBatch
from lightpycl_tpu.tracer.scene import Scene
from lightpycl_tpu.tracer.step import compact, shade

_HI = jax.lax.Precision.HIGHEST
_BIG = jnp.float32(1e30)   # finite 'no hit' sentinel (inf would poison AD)
_TINY = jnp.float32(1e-20)


# --------------------------------------------------------------------------
# Differentiable scene construction
# --------------------------------------------------------------------------

def unit_transform_rows(v0, e1, e2):
    """Per-triangle world -> unit-triangle transform rows, in jnp.

    Same transform tracer/scene.py builds in host float64 numpy, but
    differentiable: for A = [e1 | e2 | n] with n = e1 x e2, the adjugate
    gives A^-1 rows directly as cross products —
        row_u = (e2 x n) / |n|^2,  row_v = (n x e1) / |n|^2,
        row_w = n / |n|^2,
    (det A = e1 . (e2 x n) = |n|^2), with the translation -A^-1 v0 folded
    into column 4. Degenerate triangles (|n| ~ 0) get all-zero rows (same
    as build_scene's padding rows) -> DW == 0 -> never hit, and their
    gradients are exactly zero.
    """
    n = jnp.cross(e1, e2)
    det = jnp.sum(n * n, axis=-1, keepdims=True)
    # double-where, not /maximum(det, tiny): the division VJP contains
    # -1/det^2, and tiny^2 underflows f32 to 0 -> inf -> 0 * inf = nan in
    # the cotangents of every degenerate row. This form zeroes degenerate
    # rows AND their gradients exactly (matching the numpy build_scene,
    # which skips singular triangles).
    good = det > jnp.float32(1e-16)
    inv_det = jnp.where(good, 1.0 / jnp.where(good, det, 1.0), 0.0)
    ru = jnp.cross(e2, n) * inv_det
    rv = jnp.cross(n, e1) * inv_det
    rw = n * inv_det

    def _with_offset(r):
        b = -jnp.sum(r * v0, axis=-1, keepdims=True)
        return jnp.concatenate([r, b], axis=-1)

    return _with_offset(ru), _with_offset(rv), _with_offset(rw)


def scene_from_triangles(tv, mat, ior, *, reflectivity=None, detector_id=None,
                         absorb=None, ior_b=None, pad_to: int = 256) -> Scene:
    """Build a Scene pytree from a differentiable (T, 3, 3) triangle-vertex
    array. The jnp twin of tracer/scene.build_scene (which runs in host
    numpy and is opaque to autodiff): geometry flows as traced values, the
    per-triangle attribute arrays are data.

    mat/ior/...: (T,) arrays (or scalars, broadcast). Optics columns
    (polarizer axis, gratings, coatings) are zeroed — use the engine path
    for those; this path exists to differentiate GEOMETRY.
    """
    tv = jnp.asarray(tv, jnp.float32)
    T = tv.shape[0]

    def _b(x, default, dtype=jnp.float32):
        if x is None:
            x = default
        return jnp.broadcast_to(jnp.asarray(x, dtype), (T,))

    mat = _b(mat, 0, jnp.int32)
    ior = _b(ior, 1.0)
    reflectivity = _b(reflectivity, 0.0)
    detector_id = _b(detector_id, -1, jnp.int32)
    absorb = _b(absorb, 0.0)
    ior_b = _b(ior_b, 0.0)

    v0 = tv[:, 0]
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    n = jnp.cross(e1, e2)
    # NOT jnp.linalg.norm: its VJP is n/|n| = 0/0 = nan for the exactly-
    # degenerate (zero-area) triangles the uniform quad grid produces at
    # r = 0, and a downstream mask can't cancel a nan cotangent. The
    # guarded sum-of-squares form keeps the whole backward pass finite.
    n_unit = n / jnp.sqrt(
        jnp.maximum(jnp.sum(n * n, axis=1, keepdims=True), _TINY))
    wu, wv, ww = unit_transform_rows(v0, e1, e2)

    T_pad = ((max(T, 1) + pad_to - 1) // pad_to) * pad_to
    pad = T_pad - T

    def _p(a, fill=0.0):
        if pad == 0:
            return a
        return jnp.concatenate(
            [a, jnp.full((pad,) + a.shape[1:], fill, a.dtype)])

    zeros3 = jnp.zeros((T, 3), jnp.float32)
    zcol = jnp.zeros((T, 1), jnp.float32)
    return Scene(
        v0=_p(v0), e1=_p(e1), e2=_p(e2), normal=_p(n_unit),
        wu=_p(wu), wv=_p(wv), ww=_p(ww),
        mat=_p(mat, fill=int(Material.TERMINATOR)),
        ior=_p(ior, fill=1.0), ior_b=_p(ior_b), absorb=_p(absorb),
        reflectivity=_p(reflectivity),
        detector_id=_p(detector_id, fill=-1),
        axis=_p(zeros3), retardance=_p(zcol[:, 0]),
        grating_mlp=_p(zcol[:, 0]), grating_g0=_p(zcol[:, 0]),
        metal_n=_p(zcol[:, 0]), metal_k=_p(zcol[:, 0]),
        coat_ior=_p(zcol), coat_thickness=_p(zcol),
    )


# --------------------------------------------------------------------------
# Gradient-safe intersection
# --------------------------------------------------------------------------

def intersect_diff(scene: Scene, o, d, cfg: TraceConfig):
    """Nearest-hit with every intermediate finite (reverse-mode safe).

    Dense (C, T_pad) evaluation — differentiable-design scenes are small
    (10^3-10^4 triangles); the production paths (intersect_jnp / Pallas)
    stay the fast-forward implementations. Returns (t, tri) with
    t == max_ray_len and tri == -1 on miss (finite, not +inf).
    """
    C = o.shape[0]
    o4 = jnp.concatenate([o, jnp.ones((C, 1), jnp.float32)], axis=1)
    d4 = jnp.concatenate([d, jnp.zeros((C, 1), jnp.float32)], axis=1)
    OU = jnp.dot(o4, scene.wu.T, precision=_HI)
    OV = jnp.dot(o4, scene.wv.T, precision=_HI)
    OW = jnp.dot(o4, scene.ww.T, precision=_HI)
    DU = jnp.dot(d4, scene.wu.T, precision=_HI)
    DV = jnp.dot(d4, scene.wv.T, precision=_HI)
    DW = jnp.dot(d4, scene.ww.T, precision=_HI)

    ok = jnp.abs(DW) > _TINY
    DW_safe = jnp.where(ok, DW, _TINY)
    t = -OW / DW_safe
    u = OU + t * DU
    v = OV + t * DV
    hit = (ok & (t > cfg.eps) & (t < cfg.max_ray_len)
           & (jnp.minimum(u, v) >= -cfg.eps_bary)
           & (u + v <= 1.0 + cfg.eps_bary))
    tt = jnp.where(hit, t, _BIG)
    idx = jnp.argmin(tt, axis=1).astype(jnp.int32)
    tbest = jnp.min(tt, axis=1)
    valid = tbest < cfg.max_ray_len
    return (jnp.where(valid, tbest, cfg.max_ray_len),
            jnp.where(valid, idx, -1))


def trace_diff(scene: Scene, rays: RayBatch, cfg: TraceConfig,
               n_bounces: int, collect_escaped: bool = False):
    """Fixed-depth differentiable trace: an UNROLLED loop of
    intersect_diff -> shade -> compact (shade and compact reused verbatim
    from tracer/step.py — same physics as the production engine). No
    detector scatter, no early exit (lax.while_loop has no reverse-mode),
    no RNG materials. Returns the surviving RayBatch.

    collect_escaped=True additionally returns (o, d, power) stacks of
    every ray at the bounce it left the system (missed all geometry) —
    the natural input for an image-plane figure of merit: a design scene
    needs no detector surface, finished rays are evaluated in flight.
    """
    esc = []
    for _ in range(n_bounces):
        t, tri = intersect_diff(scene, rays.o, rays.d, cfg)
        if collect_escaped:
            miss = rays.alive & (tri < 0)
            esc.append((rays.o, rays.d, jnp.where(miss, rays.power, 0.0)))
        sh = shade(scene, rays, t, tri, cfg)
        rays, _ = compact(sh, rays.capacity, cfg)
    if collect_escaped:
        eo, ed, ep = (jnp.concatenate([e[i] for e in esc]) for i in range(3))
        return rays, (eo, ed, ep)
    return rays


# --------------------------------------------------------------------------
# Figures of merit
# --------------------------------------------------------------------------

def spot_rms_at_plane(o, d, power, z_plane, min_dz: float = 0.5,
                      min_power: float = 0.0):
    """Power-weighted RMS transverse spot radius of the forward-propagating
    rays (o, d, power), continued to the plane z = z_plane (about their
    weighted centroid). `min_dz` drops backward/grazing rays and
    `min_power` drops multi-reflection ghosts (a double Fresnel bounce
    carries ~0.16% of a ray's power but lands arbitrarily far off-axis —
    left in, ghosts dominate the RMS of a well-corrected lens; excluding
    them matches standard sequential merit functions). Differentiable;
    both cutoffs are locally-constant masks."""
    dz = d[:, 2]
    w = jnp.where((dz > min_dz) & (power > min_power), power, 0.0)
    t = (z_plane - o[:, 2]) / jnp.where(jnp.abs(dz) > 1e-6, dz, 1.0)
    x = o[:, 0] + t * d[:, 0]
    y = o[:, 1] + t * d[:, 1]
    wsum = jnp.maximum(jnp.sum(w), _TINY)
    xc = jnp.sum(w * x) / wsum
    yc = jnp.sum(w * y) / wsum
    r2 = (x - xc) ** 2 + (y - yc) ** 2
    return jnp.sqrt(jnp.sum(w * r2) / wsum)


# --------------------------------------------------------------------------
# Differentiable parametric meshers
# --------------------------------------------------------------------------

def sag(c, r2, k=0.0):
    """Conic sag z(r) = c r^2 / (1 + sqrt(1 - (1+k) c^2 r^2)) as a
    function of curvature c = 1/R, conic constant k (0 sphere, -1
    parabola, k < -1 hyperbola), and r^2. Smooth through c = 0 (flat) and
    differentiable in BOTH c and k; the root is clamped so parameters
    wandering past the geometric limit degrade gracefully instead of
    NaN-ing the whole gradient."""
    c = jnp.asarray(c, jnp.float32)
    k = jnp.asarray(k, jnp.float32)
    root = jnp.sqrt(jnp.maximum(1.0 - (1.0 + k) * c * c * r2, 1e-4))
    return c * r2 / (1.0 + root)


def singlet_triangles(c1, c2, thickness, aperture_radius,
                      n_seg: int = 48, n_rad: int = 12,
                      k1=0.0, k2=0.0):
    """Differentiable triangle soup (T, 3, 3) of a rotationally symmetric
    singlet lens: front spherical surface (curvature c1, vertex at z = 0),
    back surface (curvature c2, vertex at z = thickness), cylindrical edge
    wall at r = aperture_radius. Sign convention: c > 0 bulges toward -z
    (standard: biconvex is c1 > 0, c2 < 0; rays travel +z). Outward
    winding matches geometry/primitives.py (front normals -z-ish, back
    +z-ish, wall radial) so the engine's entering/exiting logic sees the
    same orientation as the numpy factory's lenses.

    The inner ring (r = 0) generates one degenerate triangle per quad —
    zero area, guarded in unit_transform_rows, never hit; keeping the
    uniform quad grid keeps every shape static for jit.
    """
    thickness = jnp.asarray(thickness, jnp.float32)
    a = jnp.asarray(aperture_radius, jnp.float32)
    th = 2.0 * np.pi * jnp.arange(n_seg + 1) / n_seg   # (S+1,) wraps
    r = a * jnp.arange(n_rad + 1) / n_rad              # (K+1,)
    cth, sth = jnp.cos(th), jnp.sin(th)

    # surface point grids (K+1, S+1, 3)
    def grid(zfun):
        x = r[:, None] * cth[None, :]
        y = r[:, None] * sth[None, :]
        z = jnp.broadcast_to(zfun(r * r)[:, None], x.shape)
        return jnp.stack([x, y, z], axis=-1)

    F = grid(lambda r2: sag(c1, r2, k1))
    B = grid(lambda r2: thickness + sag(c2, r2, k2))

    def quads(P, order):
        """Triangulate the (K, S) quad grid of P with the given corner
        order; corners: A=(k,j) Bc=(k+1,j) Cc=(k+1,j+1) D=(k,j+1)."""
        A = P[:-1, :-1].reshape(-1, 3)
        Bc = P[1:, :-1].reshape(-1, 3)
        Cc = P[1:, 1:].reshape(-1, 3)
        D = P[:-1, 1:].reshape(-1, 3)
        corners = {"A": A, "B": Bc, "C": Cc, "D": D}
        tris = [jnp.stack([corners[i] for i in o], axis=1) for o in order]
        return jnp.concatenate(tris)

    # front cap: outward normal toward -z  -> (A,D,B), (D,C,B)
    front = quads(F, [("A", "D", "B"), ("D", "C", "B")])
    # back cap: outward normal toward +z  -> (A,B,D), (D,B,C)
    back = quads(B, [("A", "B", "D"), ("D", "B", "C")])
    # wall: outward radial; rim rings at k = K of both grids
    W0 = F[-1, :-1]
    W1 = F[-1, 1:]
    W2 = B[-1, 1:]
    W3 = B[-1, :-1]
    wall = jnp.concatenate([
        jnp.stack([W0, W1, W2], axis=1),
        jnp.stack([W0, W2, W3], axis=1),
    ])
    return jnp.concatenate([front, back, wall])


def singlet_scene(c1, c2, thickness, aperture_radius, ior,
                  n_seg: int = 48, n_rad: int = 12,
                  pad_to: int = 256, k1=0.0, k2=0.0) -> Scene:
    """Scene of one refractive singlet, differentiable w.r.t. c1, c2,
    thickness, aperture_radius, and the conic constants k1/k2. Rays that
    miss the lens escape (accounted by shade); pair with
    spot_rms_at_plane for a design loss."""
    tv = singlet_triangles(c1, c2, thickness, aperture_radius,
                           n_seg=n_seg, n_rad=n_rad, k1=k1, k2=k2)
    return scene_from_triangles(
        tv, mat=int(Material.REFRACTIVE), ior=ior, pad_to=pad_to)


def collimated_bundle(n_rays: int, beam_radius, z_start: float = -1.0,
                      power: float = 1.0) -> RayBatch:
    """Deterministic +z collimated ray bundle on concentric rings
    (hexapolar-style), for design losses: no sampling noise between
    optimizer steps. Capacity is 4x n_rays to absorb Fresnel-split
    children during trace_diff."""
    n_rings = max(int(np.sqrt(n_rays / 3.0)), 1)
    rs, phis = [0.0], [0.0]
    placed = 1
    for k in range(1, n_rings + 1):
        m = 6 * k
        rr = k / n_rings
        ang = 2.0 * np.pi * (np.arange(m) + 0.5 * (k % 2)) / m
        rs.extend([rr] * m)
        phis.extend(ang.tolist())
        placed += m
        if placed >= n_rays:
            break
    rs = np.asarray(rs[:max(n_rays, 1)])
    phis = np.asarray(phis[:max(n_rays, 1)])
    n = len(rs)
    r = jnp.asarray(rs, jnp.float32) * beam_radius
    o = jnp.stack([r * jnp.cos(jnp.asarray(phis, jnp.float32)),
                   r * jnp.sin(jnp.asarray(phis, jnp.float32)),
                   jnp.full((n,), z_start, jnp.float32)], axis=1)
    d = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (n, 1))
    p = jnp.full((n,), power / n, jnp.float32)
    return RayBatch.from_arrays(o, d, p, capacity=4 * n)


def make_spot_loss(*, ior: float, thickness: float, aperture_radius: float,
                   n_rays: int = 300, beam_fill: float = 0.8,
                   n_seg: int = 48, n_rad: int = 12, n_bounces: int = 4,
                   cfg: TraceConfig | None = None):
    """Loss factory: (c1, c2, z_plane) -> RMS spot radius at z = z_plane
    for a collimated on-axis beam through the singlet. All three arguments
    are differentiable (z_plane too, so focus position can be co-optimized
    or solved for). jit'd once; feed to jax.value_and_grad / optax. The
    ray bundle is deterministic, so the loss is a smooth(ish) pure
    function of the prescription. The figure of merit is evaluated on the
    ESCAPED forward-propagating rays (the beam after it leaves the lens;
    min_dz filters backward Fresnel ghosts), so n_bounces must be >= 3:
    enter + exit + the escape-detection pass."""
    cfg = cfg or TraceConfig(backend="jnp", has_gratings=False,
                             has_coatings=False, has_metals=False)
    rays0 = collimated_bundle(n_rays, beam_fill * aperture_radius)

    per_ray = float(jnp.max(rays0.power))

    def loss(c1, c2, z_plane):
        scene = singlet_scene(c1, c2, thickness, aperture_radius, ior,
                              n_seg=n_seg, n_rad=n_rad)
        _, (eo, ed, ep) = trace_diff(scene, rays0, cfg, n_bounces,
                                     collect_escaped=True)
        # main sequential beam only: a ray that lost > 75% of its source
        # power to Fresnel reflections is a ghost, not the image
        return spot_rms_at_plane(eo, ed, ep, z_plane,
                                 min_power=0.25 * per_ray)

    return jax.jit(loss)


# --------------------------------------------------------------------------
# Differentiable EXACT-surface design (analytic quadrics)
# --------------------------------------------------------------------------
# The analytic-surface intersection (ops/quadric.py) is pure jnp, so a lens
# prescription expressed as quadric coefficients is differentiable with NO
# tessellation in the loop: gradients of curvature / conic / thickness are
# exact instead of carrying O(1/n_seg^2) facet noise. This is what makes
# third-order shape optimization possible — ROADMAP.md records that
# Coddington best-form recovery on MESHED singlets is tessellation-limited
# (the facet cone blur swamps the q-dependence); with exact caps the spot
# RMS resolves it cleanly (tests/test_diff_analytic.py).


def quadric_intersect_diff(scene: Scene, o, d, cfg: TraceConfig):
    """Gradient-safe twin of ops/quadric.intersect_quadrics: dense (C, Q)
    evaluation, guarded denominators and clamped sqrt so the reverse pass
    stays finite, finite _BIG sentinel instead of +inf on miss.

    Returns (t (C,), tri (C,) attribute-row index [-1 on miss],
    normal (C, 3) outward unit normal; zero on miss lanes)."""
    eps = jnp.float32(cfg.eps)
    eps_b = jnp.float32(max(cfg.eps_bary, 1e-6))
    t_max = jnp.float32(cfg.max_ray_len)
    abgd = scene.quad_abgd          # (Q, 4)
    rlim2 = scene.quad_rlim ** 2    # (Q, 2)
    zlim = scene.quad_zlim          # (Q, 2)
    vertex = scene.quad_vertex      # (Q, 3)
    frame = scene.quad_frame        # (Q, 3, 3)

    # local coords: (C, Q, 3)
    rel = o[:, None, :] - vertex[None, :, :]
    ol = jnp.einsum("qij,cqj->cqi", frame, rel, precision=_HI)
    dl = jnp.einsum("qij,cj->cqi", frame, d, precision=_HI)
    al, be, ga = abgd[:, 0], abgd[:, 1], abgd[:, 2]
    de = abgd[:, 3]
    # recenter at closest approach to the local origin (f32 conditioning,
    # same trick as the forward kernel)
    s0 = -jnp.sum(ol * dl, axis=-1)
    oc = ol + s0[..., None] * dl
    A = al * (dl[..., 0] ** 2 + dl[..., 1] ** 2) + be * dl[..., 2] ** 2
    B = (2.0 * al * (oc[..., 0] * dl[..., 0] + oc[..., 1] * dl[..., 1])
         + 2.0 * be * oc[..., 2] * dl[..., 2] + ga * dl[..., 2])
    Cq = (al * (oc[..., 0] ** 2 + oc[..., 1] ** 2) + be * oc[..., 2] ** 2
          + ga * oc[..., 2] + de)
    disc = B * B - 4.0 * A * Cq
    dpos = disc > 0.0
    # sqrt VJP is 1/(2 sqrt): clamp the argument away from 0 on the
    # masked-out lanes so tangent rays don't inject inf cotangents
    sq = jnp.where(dpos, jnp.sqrt(jnp.where(dpos, disc, 1.0)), 0.0)
    sgn = jnp.where(B >= 0.0, 1.0, -1.0)
    q = -0.5 * (B + sgn * sq)
    is_quad = jnp.abs(A) > _TINY
    qok = jnp.abs(q) > _TINY
    t_qa = q / jnp.where(is_quad, A, 1.0)
    t_qb = Cq / jnp.where(qok, q, 1.0)
    qvalid = is_quad & dpos & qok
    lok = jnp.abs(B) > _TINY
    t_lin = -Cq / jnp.where(lok, B, 1.0)
    lvalid = (~is_quad) & lok
    t0 = jnp.where(qvalid, t_qa, jnp.where(lvalid, t_lin, _BIG)) + s0
    t1 = jnp.where(qvalid, t_qb, _BIG) + s0

    def accept(t):
        p = ol + t[..., None] * dl
        r2 = p[..., 0] ** 2 + p[..., 1] ** 2
        z = p[..., 2]
        ok = ((t > eps) & (t < t_max)
              & (r2 >= rlim2[:, 0] * (1.0 - eps_b))
              & (r2 <= rlim2[:, 1] * (1.0 + eps_b) + eps_b)
              & (z >= zlim[:, 0] - eps_b * (1.0 + jnp.abs(zlim[:, 0])))
              & (z <= zlim[:, 1] + eps_b * (1.0 + jnp.abs(zlim[:, 1]))))
        return jnp.where(ok, t, _BIG)

    tq = jnp.minimum(accept(t0), accept(t1))      # (C, Q)
    qi = jnp.argmin(tq, axis=1).astype(jnp.int32)
    tbest = jnp.min(tq, axis=1)
    valid = tbest < t_max

    # outward normal = quadric gradient at the winning hit point
    fr = frame[qi]
    ab = abgd[qi]
    hit = o + jnp.where(valid, tbest, 0.0)[:, None] * d
    pl = jnp.einsum("cij,cj->ci", fr, hit - vertex[qi], precision=_HI)
    grad_l = jnp.stack([2.0 * ab[:, 0] * pl[:, 0],
                        2.0 * ab[:, 0] * pl[:, 1],
                        2.0 * ab[:, 1] * pl[:, 2] + ab[:, 2]], axis=1)
    n_w = jnp.einsum("ci,cij->cj", grad_l, fr, precision=_HI)
    n_w = n_w / jnp.sqrt(
        jnp.maximum(jnp.sum(n_w * n_w, axis=1, keepdims=True), _TINY))
    tri = jnp.where(valid, scene.quad_tri[qi], -1)
    return jnp.where(valid, tbest, _BIG), tri, jnp.where(
        valid[:, None], n_w, 0.0)


def analytic_singlet_scene(c1, c2, thickness, aperture_radius, ior,
                           k1=0.0, k2=0.0, pad_to: int = 256) -> Scene:
    """Scene of one EXACT-surface singlet (front conic cap, back conic cap,
    cylindrical rim — same construction as geometry/analytic.analytic_lens)
    differentiable w.r.t. c1, c2, k1, k2, thickness, and aperture_radius.
    Lensmaker convention: c = 1/R, biconvex is c1 > 0, c2 < 0; rays travel
    +z. Each surface owns one degenerate placeholder triangle for its
    attribute row (zero transform rows — the triangle pass never hits)."""
    c1 = jnp.asarray(c1, jnp.float32)
    c2 = jnp.asarray(c2, jnp.float32)
    th = jnp.asarray(thickness, jnp.float32)
    a = jnp.asarray(aperture_radius, jnp.float32)
    a2 = a * a
    s1 = sag(c1, a2, k1)                 # front sag at the rim (world z)
    s2 = sag(c2, a2, k2)                 # back sag (negative for biconvex)
    z0 = jnp.float32(0.0)

    # placeholder triangles anchor the attribute rows; all three vertices
    # coincide -> zero area -> zero transform rows in scene_from_triangles
    v_f = jnp.stack([z0, z0, z0])
    v_b = jnp.stack([z0, z0, th])
    tv = jnp.stack([jnp.stack([v_f, v_f, v_f]),
                    jnp.stack([v_b, v_b, v_b]),
                    jnp.stack([v_f, v_f, v_f])])
    scene = scene_from_triangles(tv, mat=int(Material.REFRACTIVE), ior=ior,
                                 pad_to=pad_to)

    one = jnp.float32(1.0)
    eye = jnp.eye(3, dtype=jnp.float32)
    flip = jnp.asarray([[1.0, 0.0, 0.0],     # right-handed frame with
                        [0.0, -1.0, 0.0],    # z_local = -z_world (back cap
                        [0.0, 0.0, -1.0]],   # body on its +z_local side)
                       jnp.float32)
    zeros = jnp.zeros((), jnp.float32)
    abgd = jnp.stack([
        jnp.stack([c1, c1 * (1.0 + k1), -2.0 * one, zeros]),
        jnp.stack([-c2, -c2 * (1.0 + k2), -2.0 * one, zeros]),
        jnp.stack([one, zeros, zeros, -a2]),
    ])
    sb = -s2                              # back sag in the back-cap frame
    rlim = jnp.stack([
        jnp.stack([zeros, a]), jnp.stack([zeros, a]),
        jnp.stack([zeros, 2.0 * a]),
    ])

    def _span(s):
        return jnp.stack([jnp.minimum(zeros, s), jnp.maximum(zeros, s)])

    rim_lo = s1
    rim_hi = th + s2
    zlim = jnp.stack([
        _span(s1), _span(sb),
        jnp.stack([jnp.minimum(rim_lo, rim_hi), jnp.maximum(rim_lo,
                                                            rim_hi)]),
    ])
    vertex = jnp.stack([
        jnp.stack([z0, z0, z0]), jnp.stack([z0, z0, th]),
        jnp.stack([z0, z0, z0]),
    ])
    frame = jnp.stack([eye, flip, eye])
    return scene._replace(quad_abgd=abgd, quad_rlim=rlim, quad_zlim=zlim,
                          quad_vertex=vertex, quad_frame=frame,
                          quad_tri=jnp.arange(3, dtype=jnp.int32))


def trace_diff_analytic(scene: Scene, rays: RayBatch, cfg: TraceConfig,
                        n_bounces: int, collect_escaped: bool = False):
    """trace_diff with the exact-quadric merge (the differentiable twin of
    trace_step's cfg.has_analytic branch): triangle and quadric nearest
    hits merge per ray, the winning quadric's attribute row is its
    placeholder triangle's, only the geometric normal is overridden."""
    from lightpycl_tpu.tracer.step import default_hit_attrs

    esc = []
    for _ in range(n_bounces):
        t, tri = intersect_diff(scene, rays.o, rays.d, cfg)
        tq, qtri, nq = quadric_intersect_diff(scene, rays.o, rays.d, cfg)
        use_q = tq < t
        t = jnp.where(use_q, tq, t)
        tri = jnp.where(use_q, qtri, tri)
        if collect_escaped:
            miss = rays.alive & (tri < 0)
            esc.append((rays.o, rays.d, jnp.where(miss, rays.power, 0.0)))
        attrs = default_hit_attrs(scene, jnp.maximum(tri, 0), cfg)
        attrs["normal"] = jnp.where(use_q[:, None], nq, attrs["normal"])
        sh = shade(scene, rays, t, tri, cfg, attrs=attrs)
        rays, _ = compact(sh, rays.capacity, cfg)
    if collect_escaped:
        eo, ed, ep = (jnp.concatenate([e[i] for e in esc]) for i in range(3))
        return rays, (eo, ed, ep)
    return rays


def make_analytic_spot_loss(*, ior: float, thickness: float,
                            aperture_radius: float, n_rays: int = 300,
                            beam_fill: float = 0.8, n_bounces: int = 4,
                            cfg: TraceConfig | None = None):
    """Loss factory on EXACT surfaces: (c1, c2, k1, k2, z_plane) -> RMS
    spot radius at z = z_plane for a collimated on-axis beam. All five
    arguments differentiable; no tessellation noise in the gradient. Use
    for best-form (Coddington) shape optimization, conic optimization
    (the stigmatic k = -n^2 singlet), or focus solving."""
    cfg = cfg or TraceConfig(backend="jnp", has_gratings=False,
                             has_coatings=False, has_metals=False)
    rays0 = collimated_bundle(n_rays, beam_fill * aperture_radius)
    per_ray = float(jnp.max(rays0.power))

    def loss(c1, c2, k1, k2, z_plane):
        scene = analytic_singlet_scene(c1, c2, thickness, aperture_radius,
                                       ior, k1=k1, k2=k2)
        _, (eo, ed, ep) = trace_diff_analytic(scene, rays0, cfg, n_bounces,
                                              collect_escaped=True)
        return spot_rms_at_plane(eo, ed, ep, z_plane,
                                 min_power=0.25 * per_ray)

    return jax.jit(loss)


# --------------------------------------------------------------------------
# Differentiable thin-film coating design
# --------------------------------------------------------------------------
# The device film model (physics.multilayer_rs_rp, the same Airy recursion
# the tracer evaluates per hit) is pure jnp, so it is differentiable with
# respect to every layer index and thickness. That turns the coating model
# into a coating DESIGNER: minimize the band-averaged reflectance of a
# stack by gradient descent, then hand the optimized [(n, h), ...] list
# straight to GeoObject(coating=...) and trace it. The reference carries
# no film model at all (SURVEY.md §8.5 lists coatings as absent), so this
# subsystem has no reference equivalent.


def band_reflectance(layers_n, layers_h, *, n_sub, wavelengths,
                     n_inc=1.0, cos_i=1.0, weights=None):
    """Mean unpolarized power reflectance of a lossless dielectric stack
    over a (incidence-angle x wavelength) grid — differentiable w.r.t.
    every entry of `layers_n` / `layers_h`.

    layers_n / layers_h : sequences (or 1-D arrays) of layer indices and
        physical thicknesses, layer 0 adjacent to the incident medium.
        Units: thickness and wavelength in the same unit (the engine uses
        um — GeoObject(coating=[(n, h_um), ...])).
    wavelengths : (W,) array of vacuum wavelengths spanning the band.
    cos_i : scalar or (A,) array of incidence cosines; the average runs
        over the full (A, W) grid (a +/- field-angle spec becomes one
        array of cosines).
    weights : optional (W,) spectral weights (e.g. a source spectrum or
        photopic curve); normalized internally.
    """
    from lightpycl_tpu import physics

    wl = jnp.asarray(wavelengths, jnp.float32).reshape(1, -1)
    ci = jnp.atleast_1d(jnp.asarray(cos_i, jnp.float32)).reshape(-1, 1)
    ln = [jnp.asarray(n, jnp.float32) for n in layers_n]
    lh = [jnp.asarray(h, jnp.float32) for h in layers_h]
    R = physics.multilayer_reflectance(ci, jnp.float32(n_inc), ln, lh,
                                       jnp.float32(n_sub), wl)
    if weights is None:
        return jnp.mean(R)
    w = jnp.asarray(weights, jnp.float32).reshape(1, -1)
    w = w / jnp.maximum(jnp.sum(w), _TINY)
    return jnp.mean(jnp.sum(R * w, axis=1))


def design_coating(n_layers: int, *, n_sub, wavelengths, n_inc=1.0,
                   cos_i=1.0, fixed_n=None, init_n=None, init_h=None,
                   weights=None, n_min=1.05, n_max=4.0,
                   steps=1500, lr=0.03, seed=0):
    """Gradient-descent anti-reflection design: minimize the band-averaged
    unpolarized reflectance of an `n_layers` stack on substrate `n_sub`.

    fixed_n : optional sequence of layer indices to HOLD FIXED (the
        realistic catalog-material case — e.g. [1.38, 2.10] MgF2/ZrO2 for
        a V-coat); only thicknesses optimize. Otherwise indices
        co-optimize inside [n_min, n_max] via a sigmoid reparametrization
        (thicknesses stay positive via softplus), so the descent is
        unconstrained and cannot leave the physical domain.
    init_n / init_h : optional starting stack (defaults: indices spread in
        [1.3, 1.9] alternating, thicknesses quarter-wave at the band
        center).
    Returns (n, h, R_mean): optimized float numpy arrays and the achieved
    mean band reflectance. `list(zip(n, h))` is a ready
    GeoObject(coating=...) argument.
    """
    import optax

    wl_arr = np.atleast_1d(np.asarray(wavelengths, np.float64))
    wl0 = float(wl_arr.mean())
    if init_n is None:
        init_n = [1.38 if k % 2 == 0 else 1.9 for k in range(n_layers)]
    if init_h is None:
        base = fixed_n if fixed_n is not None else init_n
        init_h = [wl0 / (4.0 * float(n)) for n in base]
    if fixed_n is not None and len(fixed_n) != n_layers:
        raise ValueError("fixed_n must have n_layers entries")
    if len(init_h) != n_layers or (fixed_n is None
                                   and len(init_n) != n_layers):
        raise ValueError("init stack must have n_layers entries")

    h_scale = wl0 / 4.0  # softplus(x) ~ O(1) -> thickness ~ quarter-wave

    def _inv_softplus(y):
        y = np.maximum(y, 1e-6)
        return np.where(y > 30.0, y, np.log(np.expm1(y)))

    def _inv_sigmoid(p):
        p = np.clip(p, 1e-6, 1.0 - 1e-6)
        return np.log(p / (1.0 - p))

    xh0 = jnp.asarray(_inv_softplus(np.asarray(init_h) / h_scale),
                      jnp.float32)
    if fixed_n is None:
        frac = (np.asarray(init_n, np.float64) - n_min) / (n_max - n_min)
        xn0 = jnp.asarray(_inv_sigmoid(frac), jnp.float32)
        params = {"xn": xn0, "xh": xh0}
    else:
        params = {"xh": xh0}
        n_fixed = jnp.asarray(fixed_n, jnp.float32)

    def unpack(p):
        h = jax.nn.softplus(p["xh"]) * h_scale
        if fixed_n is None:
            n = n_min + (n_max - n_min) * jax.nn.sigmoid(p["xn"])
        else:
            n = n_fixed
        return n, h

    def loss(p):
        n, h = unpack(p)
        return band_reflectance(list(n), list(h), n_sub=n_sub,
                                wavelengths=wavelengths, n_inc=n_inc,
                                cos_i=cos_i, weights=weights)

    opt = optax.adam(lr)
    state = opt.init(params)

    @jax.jit
    def step(params, state):
        # val is the loss at the INPUT params, so (val, input params)
        # pairs are consistent for best-iterate tracking
        val, g = jax.value_and_grad(loss)(params)
        upd, state = opt.update(g, state)
        return optax.apply_updates(params, upd), state, val

    best_v, best_p = float(jax.jit(loss)(params)), params
    for it in range(steps):
        new_params, state, val = step(params, state)
        v = float(val)
        if v < best_v:
            best_v, best_p = v, params
        params = new_params
    v = float(jax.jit(loss)(params))   # the loop never scores the last step
    if v < best_v:
        best_v, best_p = v, params
    # report the best iterate (adam can overshoot near convergence)
    n, h = unpack(best_p)
    return np.asarray(n, np.float64), np.asarray(h, np.float64), best_v
