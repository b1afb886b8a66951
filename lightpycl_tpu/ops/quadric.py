"""Exact quadric-surface intersection — the analytic-surface hot path.

Companion of `geometry/analytic.py` (extension over the reference, whose
surfaces are all tessellated triangle meshes — SURVEY.md §3 "Primitive mesh
factory"): each `AnalyticSurface` in a scene is intersected EXACTLY here
instead of through its (placeholder) triangle, eliminating facet-cone blur
on curved optics.

Design: a `lax.scan` over the Q surfaces with an O(C) carry (running
nearest t + surface index) — Q is a handful of rows, so this is a tiny
fused elementwise epilogue next to the triangle kernel, not a kernel of
its own. All math is f32 like the triangle path; a ray-recentering step
(solve around the closest approach to the surface vertex) keeps the
quadratic well-conditioned when origins sit far from the element.

Surface model (geometry/analytic.py module docstring): in the surface's
local frame, alpha (x^2 + y^2) + beta z^2 + gamma z + delta = 0, bounded by
r in [r_min, r_max] and z in [z_lo, z_hi]; conics use the gamma = -2
normalization, cylinders alpha = 1, gamma = 0. The outward normal is the
gradient (2 alpha x, 2 alpha y, 2 beta z + gamma), which points away from
the element body by construction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# python float, NOT jnp.float32(...): a module-level device array would be
# lifted into every enclosing jaxpr as a captured-constant executable input,
# which the donation fastpath mis-binds on repeat execution ("supplied N
# buffers but compiled program expected N+3")
_INF = float("inf")

# geometry matmuls must never run at a reduced matmul precision: TF32
# truncation of the frame transforms silently shifts hit points by
# ~1e-3 of the scene scale — exactly the facet-scale error this module
# exists to eliminate (CLAUDE.md invariant; matches diff.py / step.py)
_HI = jax.lax.Precision.HIGHEST


def _intersect_one(o, d, abgd, rlim2, zlim, vertex, frame, eps, eps_b,
                   t_max):
    """Nearest valid hit of C rays on ONE bounded quadric: t (C,), +inf on
    miss. o, d (C, 3) world; params as in the module docstring (rlim2 holds
    the SQUARED radial bounds)."""
    al, be, ga, de = abgd[0], abgd[1], abgd[2], abgd[3]
    # local coords (frame rows = axes); true-f32 matmul, see _HI above
    ol = jnp.matmul(o - vertex, frame.T, precision=_HI)
    dl = jnp.matmul(d, frame.T, precision=_HI)
    # recenter the ray at its closest approach to the local origin: the
    # quadratic's coefficients then involve only O(scene-size) magnitudes
    # even when the origin is max_ray_len away (f32 conditioning)
    s0 = -jnp.sum(ol * dl, axis=1)
    oc = ol + s0[:, None] * dl
    A = al * (dl[:, 0] ** 2 + dl[:, 1] ** 2) + be * dl[:, 2] ** 2
    B = (2.0 * al * (oc[:, 0] * dl[:, 0] + oc[:, 1] * dl[:, 1])
         + 2.0 * be * oc[:, 2] * dl[:, 2] + ga * dl[:, 2])
    Cq = (al * (oc[:, 0] ** 2 + oc[:, 1] ** 2) + be * oc[:, 2] ** 2
          + ga * oc[:, 2] + de)
    disc = B * B - 4.0 * A * Cq
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    # numerically stable root pair: q = -(B + sign(B) sqrt(disc)) / 2,
    # roots q/A and Cq/q (classic citardauq); q == 0 only at a double root
    # through the recentered origin, where both roots are ~0 and the
    # t > eps guard rejects them anyway
    sgn = jnp.where(B >= 0.0, 1.0, -1.0)
    q = -0.5 * (B + sgn * sq)
    is_quad = A != 0.0                   # planes/walls hit A == 0 exactly
    t_qa = q / jnp.where(is_quad, A, 1.0)
    t_qb = Cq / jnp.where(q != 0.0, q, 1.0)
    qvalid = is_quad & (disc >= 0.0) & (q != 0.0)
    # linear case (plane, or a cylinder wall seen axis-parallel): B t + C
    t_lin = -Cq / jnp.where(B != 0.0, B, 1.0)
    lvalid = (~is_quad) & (B != 0.0)
    t0 = jnp.where(qvalid, t_qa, jnp.where(lvalid, t_lin, _INF)) + s0
    t1 = jnp.where(qvalid, t_qb, _INF) + s0

    def accept(t):
        p = ol + t[:, None] * dl         # hit point, local frame
        r2 = p[:, 0] ** 2 + p[:, 1] ** 2
        z = p[:, 2]
        ok = ((t > eps) & (t < t_max)
              & (r2 >= rlim2[0] * (1.0 - eps_b))
              & (r2 <= rlim2[1] * (1.0 + eps_b) + eps_b)
              & (z >= zlim[0] - eps_b * (1.0 + jnp.abs(zlim[0])))
              & (z <= zlim[1] + eps_b * (1.0 + jnp.abs(zlim[1]))))
        return jnp.where(ok, t, _INF)

    return jnp.minimum(accept(t0), accept(t1))


def intersect_quadrics(scene, o, d, cfg):
    """Nearest hit of C rays over the scene's Q analytic surfaces.

    Returns (t (C,) f32 +inf on miss, tri (C,) i32 attribute-row index
    [-1 on miss], normal (C, 3) f32 outward unit normal at the hit point;
    arbitrary-but-finite on miss lanes — callers mask on t).
    """
    eps = jnp.float32(cfg.eps)
    # radial/axial boundary slack mirrors the triangle test's barycentric
    # slack (cfg.eps_bary) so rim hits don't flicker between the two paths
    eps_b = jnp.float32(max(cfg.eps_bary, 1e-6))
    t_max = jnp.float32(cfg.max_ray_len)
    abgd = scene.quad_abgd
    rlim2 = scene.quad_rlim ** 2
    zlim = scene.quad_zlim
    vertex = scene.quad_vertex
    frame = scene.quad_frame
    Q = abgd.shape[0]

    def body(carry, xs):
        best_t, best_i = carry
        ab, r2, zl, vx, fr, i = xs
        t = _intersect_one(o, d, ab, r2, zl, vx, fr, eps, eps_b, t_max)
        better = t < best_t
        return (jnp.where(better, t, best_t),
                jnp.where(better, i, best_i)), None

    init = (jnp.full((o.shape[0],), _INF),
            jnp.full((o.shape[0],), -1, jnp.int32))
    (bt, bi), _ = jax.lax.scan(
        body, init,
        (abgd, rlim2, zlim, vertex, frame, jnp.arange(Q, dtype=jnp.int32)))

    # outward normal = quadric gradient at the hit point (one gather of the
    # winning surface's params; miss lanes get finite placeholder values)
    safe = jnp.maximum(bi, 0)
    fr = frame[safe]                      # (C, 3, 3)
    ab = abgd[safe]                       # (C, 4)
    hit = o + jnp.where(jnp.isfinite(bt), bt, 0.0)[:, None] * d
    pl = jnp.einsum("cij,cj->ci", fr, hit - vertex[safe], precision=_HI)
    grad_l = jnp.stack([2.0 * ab[:, 0] * pl[:, 0],
                        2.0 * ab[:, 0] * pl[:, 1],
                        2.0 * ab[:, 1] * pl[:, 2] + ab[:, 2]], axis=1)
    n_w = jnp.einsum("ci,cij->cj", grad_l, fr, precision=_HI)
    n_w = n_w / jnp.maximum(
        jnp.linalg.norm(n_w, axis=1, keepdims=True), 1e-20)
    tri = jnp.where(jnp.isfinite(bt), scene.quad_tri[safe], -1)
    return bt, tri, n_w
