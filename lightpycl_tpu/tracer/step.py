"""The jitted trace step: intersect -> shade/split -> compact.

Reference parity: one iteration of CL_Tracer.iterative_tracer's device loop
(SURVEY.md §4.3): the `intersect` kernel (nearest hit over all triangles),
the `reflect_refract` kernel (Snell / TIR / Fresnel power split producing up
to 2 child rays; material dispatch mirror / dielectric / terminator /
measure), then ray compaction. Unlike the reference — which reads buffers
back to the host and compacts in numpy every iteration — everything here
stays on device: compaction is a top-k selection over the 2C child slots and
the measurement surfaces accumulate into an on-device histogram, so a full
multi-bounce trace is a single XLA computation (host sync once at the end).

Shapes are static everywhere: C = ray capacity, children land in 2C slots
(reflected child of ray i at slot i, refracted at C + i), and compaction
selects the C highest-power live children (dropped overflow is accounted as
'culled' power so the conservation ledger stays exact — SURVEY.md §7).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from lightpycl_tpu import physics
from lightpycl_tpu.materials import Material
from lightpycl_tpu.tracer.config import TraceConfig
from lightpycl_tpu.tracer.rays import DetectorState, Ledger, RayBatch
from lightpycl_tpu.tracer.scene import Scene

# python float, NOT jnp.float32(...): a module-level device array is lifted
# into every enclosing jaxpr as a captured-constant executable input, which
# the donation fastpath can mis-bind on repeat execution (see ops/quadric.py)
_INF = float("inf")


# --------------------------------------------------------------------------
# Intersection (the plain reference and CPU path; the GPU kernel is in ops/)
# --------------------------------------------------------------------------

def _intersect_tile(o4, d4, wu, wv, ww, eps, eps_b, t_max):
    """Nearest hit of C rays against one tile of K triangles.

    o4 (C,4) homogeneous origins, d4 (C,4) directions (w=0); wu/wv/ww (K,4)
    unit-transform rows. Returns (t (C,), idx (C,) argmin within tile).
    Same math as the GPU kernel, written as matmuls — see
    tracer/scene.py for the derivation and its equivalence to
    Möller–Trumbore (reference kernel: SURVEY.md §3 'Intersect kernel').
    """
    # precision=HIGHEST: a default-precision f32 matmul may run in TF32,
    # which wrecks the ill-conditioned transforms of skinny triangles
    # (e.g. pole fans) and leaks double-digit percentages of power.
    f32 = jnp.float32
    hi = jax.lax.Precision.HIGHEST
    OU = jnp.dot(o4, wu.T, preferred_element_type=f32, precision=hi)
    OV = jnp.dot(o4, wv.T, preferred_element_type=f32, precision=hi)
    OW = jnp.dot(o4, ww.T, preferred_element_type=f32, precision=hi)
    DU = jnp.dot(d4, wu.T, preferred_element_type=f32, precision=hi)
    DV = jnp.dot(d4, wv.T, preferred_element_type=f32, precision=hi)
    DW = jnp.dot(d4, ww.T, preferred_element_type=f32, precision=hi)

    # IEEE semantics (same as the Pallas kernel): DW == 0 gives t = +-inf
    # (OW != 0) or NaN (OW == 0, incl. all-zero padding rows), and every
    # comparison below is false for both -> no hit, no guard ops needed.
    t = -OW / DW
    u = OU + t * DU
    v = OV + t * DV
    hit = (
        (t > eps)
        & (t < t_max)
        & (u >= -eps_b)
        & (v >= -eps_b)
        & (u + v <= 1.0 + eps_b)
    )
    tt = jnp.where(hit, t, _INF)
    idx = jnp.argmin(tt, axis=1)
    return jnp.min(tt, axis=1), idx.astype(jnp.int32)


def intersect_jnp(scene: Scene, o, d, cfg: TraceConfig, ray_block: int = 4096):
    """Nearest-hit over the whole scene, tiled (ray_block x tri_chunk) so
    intermediates stay small. Returns (t (C,), tri (C,) i32; tri == -1 and
    t == +inf on miss)."""
    C = o.shape[0]
    Tp = scene.num_triangles_padded
    chunk = int(min(cfg.tri_chunk, Tp))
    n_chunks = -(-Tp // chunk)
    pad_t = n_chunks * chunk - Tp

    def _padt(a):
        return jnp.pad(a, ((0, pad_t), (0, 0))) if pad_t else a

    wu = _padt(scene.wu).reshape(n_chunks, chunk, 4)
    wv = _padt(scene.wv).reshape(n_chunks, chunk, 4)
    ww = _padt(scene.ww).reshape(n_chunks, chunk, 4)

    rb = int(min(ray_block, C))
    n_rblocks = -(-C // rb)
    pad_r = n_rblocks * rb - C
    o_p = jnp.pad(o, ((0, pad_r), (0, 0))) if pad_r else o
    d_p = jnp.pad(d, ((0, pad_r), (0, 0))) if pad_r else d
    o4 = jnp.concatenate([o_p, jnp.ones((o_p.shape[0], 1), jnp.float32)], axis=1)
    d4 = jnp.concatenate([d_p, jnp.zeros((d_p.shape[0], 1), jnp.float32)], axis=1)
    o4 = o4.reshape(n_rblocks, rb, 4)
    d4 = d4.reshape(n_rblocks, rb, 4)

    eps = jnp.float32(cfg.eps)
    eps_b = jnp.float32(cfg.eps_bary)
    t_max = jnp.float32(cfg.max_ray_len)

    def per_ray_block(args):
        o4b, d4b = args

        def tri_scan(carry, tile):
            best_t, best_i = carry
            wu_k, wv_k, ww_k, off = tile
            t, i = _intersect_tile(o4b, d4b, wu_k, wv_k, ww_k, eps, eps_b, t_max)
            better = t < best_t
            return (
                jnp.where(better, t, best_t),
                jnp.where(better, i + off, best_i),
            ), None

        offs = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
        init = (jnp.full((rb,), _INF), jnp.full((rb,), -1, jnp.int32))
        (bt, bi), _ = jax.lax.scan(tri_scan, init, (wu, wv, ww, offs))
        return bt, bi

    bt, bi = jax.lax.map(per_ray_block, (o4, d4))
    bt = bt.reshape(-1)[:C]
    bi = bi.reshape(-1)[:C]
    return bt, jnp.where(jnp.isfinite(bt), bi, -1)


def nearest_t_rows(o, d, wu, wv, ww, cfg: TraceConfig, ray_block: int = 4096):
    """Nearest-hit DISTANCE of C rays against an arbitrary compact set of
    unit-transform rows (no triangle ids) — the GRIN multi-substep path's
    own-surface check (TraceConfig.grin_substeps). Same hit predicate as
    intersect_jnp so step decisions match the full intersect exactly."""
    C = o.shape[0]
    Tp = wu.shape[0]
    chunk = int(min(128, Tp))
    n_chunks = -(-Tp // chunk)  # build pads to a 128 multiple already
    wu_t = wu.reshape(n_chunks, chunk, 4)
    wv_t = wv.reshape(n_chunks, chunk, 4)
    ww_t = ww.reshape(n_chunks, chunk, 4)

    rb = int(min(ray_block, C))
    n_rblocks = -(-C // rb)
    pad_r = n_rblocks * rb - C
    o_p = jnp.pad(o, ((0, pad_r), (0, 0))) if pad_r else o
    d_p = jnp.pad(d, ((0, pad_r), (0, 0))) if pad_r else d
    o4 = jnp.concatenate([o_p, jnp.ones((o_p.shape[0], 1), jnp.float32)],
                         axis=1).reshape(n_rblocks, rb, 4)
    d4 = jnp.concatenate([d_p, jnp.zeros((d_p.shape[0], 1), jnp.float32)],
                         axis=1).reshape(n_rblocks, rb, 4)
    eps = jnp.float32(cfg.eps)
    eps_b = jnp.float32(cfg.eps_bary)
    t_max = jnp.float32(cfg.max_ray_len)

    def per_ray_block(args):
        o4b, d4b = args

        def tri_scan(best_t, tile):
            t, _ = _intersect_tile(o4b, d4b, *tile, eps, eps_b, t_max)
            return jnp.minimum(best_t, t), None

        bt, _ = jax.lax.scan(tri_scan, jnp.full((rb,), _INF),
                             (wu_t, wv_t, ww_t))
        return bt

    return jax.lax.map(per_ray_block, (o4, d4)).reshape(-1)[:C]


def intersect(scene: Scene, o, d, cfg: TraceConfig, alive=None):
    """Nearest hit, by platform: the Pallas kernel (ops/intersect_gpu.py)
    on the GPU, intersect_jnp elsewhere and whenever cfg.backend == 'jnp'.
    `alive` (optional) lets the kernel's cull skip all-dead ray blocks.
    A kernel that fails to build raises; nothing falls back."""
    if cfg.backend not in ("auto", "jnp"):
        raise ValueError(f"TraceConfig.backend must be 'auto' or 'jnp', "
                         f"got {cfg.backend!r}")
    if cfg.backend == "auto" and jax.default_backend() == "gpu":
        from lightpycl_tpu.ops.intersect_gpu import intersect_gpu

        return intersect_gpu(scene, o, d, cfg, alive=alive)
    return intersect_jnp(scene, o, d, cfg)


# --------------------------------------------------------------------------
# Ray reordering (coherence for the cull mask)
# --------------------------------------------------------------------------

def _spread3(x):
    """Spread 10 bits to every 3rd bit (Morton encoding helper)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_order(o, alive, lo, hi):
    """Permutation sorting rays by the Morton code of their origins
    (10 bits/axis over [lo, hi]); dead rays sort to the end.

    Spatially-local ray blocks are what make the Pallas kernel's
    conservative block x tile cull effective (PAPERS.md: 'On Ray Reordering
    Techniques for Faster GPU Ray Tracing' — same idea: sort
    once per bounce, blocks become coherent patches)."""
    span = jnp.maximum(hi - lo, 1e-20)
    q = jnp.clip(((o - lo) / span * 1023.0), 0.0, 1023.0).astype(jnp.uint32)
    code = (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1)
            | (_spread3(q[:, 2]) << 2))
    # dead rays get the max key so live rays pack into coherent blocks
    code = jnp.where(alive, code, jnp.uint32(0xFFFFFFFF))
    return jnp.argsort(code)


def reorder_rays(scene: Scene, rays: RayBatch) -> RayBatch:
    """Morton-sort the batch in place (ray order is semantically free: every
    downstream quantity is per-ray or a sum)."""
    # bounds over VALID triangles only: padding rows are zero vectors and
    # would stretch the quantization box to include the origin
    valid = jnp.any(scene.ww != 0.0, axis=1)[:, None]
    lo = jnp.min(jnp.where(valid, scene.v0, jnp.float32(3.4e38)), axis=0)
    hi = jnp.max(jnp.where(valid, scene.v0, jnp.float32(-3.4e38)), axis=0)
    order = morton_order(rays.o, rays.alive, lo, hi)
    return jax.tree_util.tree_map(lambda a: a[order], rays)


# --------------------------------------------------------------------------
# Shade: material dispatch, Snell/Fresnel split, measurement
# --------------------------------------------------------------------------

class ShadeOut(NamedTuple):
    child_o: jnp.ndarray       # (2C, 3)
    child_d: jnp.ndarray       # (2C, 3)
    child_power: jnp.ndarray   # (2C,)
    child_ior: jnp.ndarray     # (2C,)
    child_wavelength: jnp.ndarray  # (2C,)
    child_absorb: jnp.ndarray  # (2C,) medium absorption coefficient
    policy_dropped: jnp.ndarray  # () power dropped by allow_splitting=False
    child_s1: jnp.ndarray      # (2C,) Stokes fractions (polarization)
    child_s2: jnp.ndarray      # (2C,)
    child_s3: jnp.ndarray      # (2C,)
    child_basis: jnp.ndarray   # (2C,3) polarization frame s-direction
    child_opl: jnp.ndarray     # (2C,) accumulated optical path length
    child_alive: jnp.ndarray   # (2C,) bool
    hit_point: jnp.ndarray     # (C, 3) parent hit / termination point
    measured: jnp.ndarray      # (C,) bool parent measured this step
    measured_power: jnp.ndarray  # (C,)
    det_id: jnp.ndarray        # (C,) i32
    absorbed: jnp.ndarray      # () power absorbed this step
    escaped: jnp.ndarray       # () power escaped (miss) this step
    escaped_power: jnp.ndarray  # (C,) per-parent escaped power (zero on
    #   non-miss slots; escaped == sum(escaped_power)). Lets spectral
    #   tracing bin the ledger per wavelength without re-deriving is_miss.
    dropped_power: jnp.ndarray  # (C,) per-parent power dropped by
    #   allow_splitting=False (policy_dropped == sum(dropped_power);
    #   all-zero when splitting is enabled)
    child_path: jnp.ndarray    # (2C,) f32 path signatures
    #   (cfg.track_paths appends this bounce's (element, branch) digit;
    #   otherwise the parent signature passes through unchanged)
    child_scat: jnp.ndarray    # (2C,) medium scattering coefficient mu_s
    child_scat_g: jnp.ndarray  # (2C,) medium Henyey-Greenstein anisotropy
    child_medium: jnp.ndarray  # (2C,) current-medium element id (-1 =
    #   ambient; drives the fluorescence tables)
    atten: jnp.ndarray         # (C,) Beer-Lambert bulk transmission over
    #   the segment just traveled (1.0 outside absorbing media). The
    #   flux_map scatter multiplies the parent's start-of-segment power
    #   by this so incident flux inside absorbing media is not overcounted


def gather_hit_attrs(scene: Scene, safe_tri, with_optics: bool = True,
                     with_coatings: bool = True, with_bire=None,
                     with_scatter=None, with_rough=None):
    """Per-hit triangle attributes (the gathers shade needs). Separated so
    triangle-sharded tracing can substitute collectively-gathered values
    (parallel/mesh2d.py).

    One fused (T, 11) or (T, 17) gather instead of up-to-ten separate
    gathers — stacking the per-triangle columns is O(T) elementwise
    (cheap, fused by XLA); the per-ray gather is the expensive part and
    runs once. mat and detector_id ride along as f32 (tiny ints, exact).
    `with_optics` adds the polarizer/waveplate/grating columns (axis,
    retardance, m/period, order0 fraction — indices 11..16; then the
    birefringent n_e column when enabled, then coatings); shade skips them
    when the static config says no such elements exist. Base columns
    include the metal-mirror (n, k) pair at 9..10. `with_bire` (None =
    auto: the scene carries the column) rides the extraordinary principal
    index along — hand-built scenes (diff.py) without it stay valid.
    `with_scatter` (same None = auto convention) adds the bulk
    (scat_mu, scat_g) pair the refracted child inherits."""
    if with_bire is None:
        with_bire = getattr(scene, "bire_ne", None) is not None
    if with_scatter is None:
        with_scatter = getattr(scene, "scat_mu", None) is not None
    if with_rough is None:
        with_rough = getattr(scene, "rough_sigma", None) is not None
    with_disp2 = getattr(scene, "ior_c", None) is not None
    cols = [scene.mat.astype(jnp.float32)[:, None], scene.normal,
            scene.ior[:, None], scene.ior_b[:, None],
            scene.reflectivity[:, None],
            scene.detector_id.astype(jnp.float32)[:, None],
            scene.absorb[:, None],
            scene.metal_n[:, None], scene.metal_k[:, None]]
    if with_optics:
        cols += [scene.axis, scene.retardance[:, None],
                 scene.grating_mlp[:, None], scene.grating_g0[:, None]]
    if with_bire:
        cols += [scene.bire_ne[:, None]]
    if with_scatter:
        cols += [scene.scat_mu[:, None], scene.scat_g[:, None]]
    if with_rough:
        cols += [scene.rough_sigma[:, None], scene.rough_g[:, None]]
    if with_disp2:
        cols += [scene.ior_c[:, None]]
    if with_coatings:
        cols += [scene.coat_ior, scene.coat_thickness]  # (T, L) each
    g = jnp.concatenate(cols, axis=1)[safe_tri]
    out = {
        "mat": g[:, 0].astype(jnp.int32),
        "normal": g[:, 1:4],
        "ior": g[:, 4],
        "ior_b": g[:, 5],
        "reflectivity": g[:, 6],
        "detector_id": g[:, 7].astype(jnp.int32),
        "absorb": g[:, 8],
        "metal_n": g[:, 9],
        "metal_k": g[:, 10],
    }
    k = 11
    if with_optics:
        out["axis"] = g[:, 11:14]
        out["retardance"] = g[:, 14]
        out["grating_mlp"] = g[:, 15]
        out["grating_g0"] = g[:, 16]
        k = 17
    if with_bire:
        out["bire_ne"] = g[:, k]
        k += 1
    if with_scatter:
        out["scat_mu"] = g[:, k]
        out["scat_g"] = g[:, k + 1]
        k += 2
    if with_rough:
        out["rough_sigma"] = g[:, k]
        out["rough_g"] = g[:, k + 1]
        k += 2
    if with_disp2:
        out["ior_c"] = g[:, k]
        k += 1
    if with_coatings:
        L = scene.coat_ior.shape[1]
        out["coat_ior"] = g[:, k:k + L]
        out["coat_thickness"] = g[:, k + L:k + 2 * L]
    return out


def default_hit_attrs(scene, safe_tri, cfg):
    """The cfg-gated gather shade performs when no attrs override is
    given — exposed so trace_step's analytic-surface merge (and any other
    normal-overriding caller) builds the identical attribute set."""
    return gather_hit_attrs(
        scene, safe_tri,
        with_optics=cfg.polarization or cfg.has_gratings,
        with_coatings=cfg.has_coatings,
        with_bire=(cfg.has_birefringence and cfg.polarization
                   and getattr(scene, "bire_ne", None) is not None),
        with_scatter=(cfg.has_scattering
                      and getattr(scene, "scat_mu", None) is not None),
        with_rough=(cfg.has_roughness
                    and getattr(scene, "rough_sigma", None) is not None))


def _shade_birefringent(scene, rays, sn, attrs, live_p, s_dir, hit_valid,
                        cfg):
    """Per-lane quantities for BIREFRINGENT (uniaxial crystal) hits.

    Extension over the reference (isotropic optics only). Model:

      * ENTRY (outside -> crystal): the incident Stokes state projects
        onto the crystal's two eigenmodes (exact Malus decomposition of
        the coherence matrix): slot A carries the ORDINARY child (Snell
        refraction with n_o — sn already computed it, since the element's
        `ior` is n_o), slot B the EXTRAORDINARY child (wave-vector
        tangential matching on the e normal surface + Poynting walk-off,
        physics.uniaxial_refract_wave / uniaxial_ray_direction). Each
        child pays the Fresnel transmittance of its eigenmode
        (s/p-decomposed by the eigenpolarization's orientation — exact
        when the optic axis is in or normal to the incidence plane, the
        standard approximation otherwise); the externally REFLECTED share
        is accounted as absorbed (two child slots; crystal-face ghosts
        are out of model — use track_paths on isotropic surfaces).
      * EXIT (crystal -> ambient): slot A = transmitted child (o: exact
        Snell via sn; e: Snell applied to the recovered WAVE normal —
        physics.uniaxial_wave_from_ray), slot B = the internally
        reflected same-mode child, so TIR falls out with R = 1 and
        nothing is lost (e -> o mode conversion on internal reflection is
        neglected; the reflected e-wave re-solves the dispersion
        relation, so its direction and index are self-consistent).

    The e-ray's carried `ior` is its OPL-EFFECTIVE ray index
    n(theta_k) cos(rho) (= K . S), which keeps the generic
    opl += ior * t accumulation exact along the walked-off ray; exit
    lanes re-identify the mode by |ior - n_o| (degenerate only where the
    modes physically coincide). Dispersion of n_o/n_e is not modeled.
    Children are fully polarized (s1 = 1) in their eigenframe basis.
    """
    d = rays.d
    n = sn["n"]                      # oriented against the ray
    entering = sn["entering"]
    n1 = sn["n1"]
    cos_i = sn["cos_i"]
    n_o = attrs["ior"]
    n_e = attrs["bire_ne"]
    c_axis = attrs["axis"]
    mat = attrs["mat"]
    is_bire = hit_valid & (mat == int(Material.BIREFRINGENT))
    safe_ne = jnp.where(n_e > 0.0, n_e, 1.0)   # non-bire lanes: inert math
    safe_no = jnp.maximum(n_o, 1e-6)

    def _perp(v, ref):
        """Component of v perpendicular to unit ref, normalized; falls
        back to an orthonormal tangent of ref when degenerate."""
        p = v - physics.dot(v, ref)[:, None] * ref
        p2 = jnp.sum(p * p, axis=1, keepdims=True)
        fb, _ = physics.orthonormal_basis(ref)
        return jnp.where(p2 > 1e-12, p / jnp.sqrt(jnp.maximum(p2, 1e-20)),
                         fb)

    def _eigen_T(cos_t, n_in, n_out, w_s, tir):
        """Fresnel power transmittance of an eigenmode whose polarization
        has fraction w_s along the incidence s-direction."""
        rs, rp, _, _ = physics.fresnel_amplitudes(cos_i, cos_t, n_in, n_out)
        T = w_s * (1.0 - rs * rs) + (1.0 - w_s) * (1.0 - rp * rp)
        return jnp.where(tir, 0.0, jnp.clip(T, 0.0, 1.0))

    # ---- ENTRY ----------------------------------------------------------
    into = -n
    kt = n1[:, None] * (d - physics.dot(d, n)[:, None] * n)
    # ordinary wave: sn's dielectric quantities ARE the o-wave (tri ior
    # column = n_o)
    k_o = sn["refr_dir"]
    o_hat = physics.normalize(jnp.cross(c_axis, k_o))
    o_ok = jnp.sum(jnp.cross(c_axis, k_o) ** 2, axis=1) > 1e-12
    o_hat = jnp.where(o_ok[:, None], o_hat, s_dir)
    # Malus projection of the incident Stokes state onto the o eigenmode
    o_perp = _perp(o_hat, d)
    cos_b = physics.dot(rays.basis, o_perp)
    sin_b = physics.dot(jnp.cross(rays.basis, o_perp), d)
    b1, _ = physics.rotate_stokes(rays.s1, rays.s2, cos_b, sin_b)
    f_o = 0.5 * (1.0 + b1)
    w_s_o = physics.dot(o_perp, s_dir) ** 2
    T_o = _eigen_T(sn["cos_t"], n1, safe_no, w_s_o, sn["tir"])
    # extraordinary wave: tangential matching on the e normal surface
    K_e, e_prop = physics.uniaxial_refract_wave(kt, into, c_axis,
                                                safe_no, safe_ne)
    s_e, n_ray_e = physics.uniaxial_ray_direction(K_e, c_axis,
                                                  safe_no, safe_ne)
    n_wave_e = jnp.sqrt(jnp.maximum(physics.dot(K_e, K_e), 1e-12))
    cos_t_e = jnp.clip(physics.dot(K_e, into) / n_wave_e, 0.0, 1.0)
    e_in_perp = _perp(c_axis, d)     # e-pol: principal-plane component
    w_s_e = physics.dot(e_in_perp, s_dir) ** 2
    T_e = _eigen_T(cos_t_e, n1, n_wave_e, w_s_e, ~e_prop)
    pa_in = live_p * f_o * T_o
    pb_in = live_p * (1.0 - f_o) * T_e
    basis_a_in = _perp(o_hat, k_o)
    basis_b_in = _perp(c_axis, s_e)

    # ---- EXIT -----------------------------------------------------------
    is_e = jnp.abs(rays.ior - n_o) > 1e-4
    # e-mode: recover the wave normal from the ray direction
    k_in_hat, n_wave_x = physics.uniaxial_wave_from_ray(d, c_axis,
                                                        safe_no, safe_ne)
    K_in = n_wave_x[:, None] * k_in_hat
    kt_x = K_in - physics.dot(K_in, n)[:, None] * n
    n_out = sn["n2"]                 # ambient on exit lanes
    kt2_x = physics.dot(kt_x, kt_x)
    tir_e = kt2_x > n_out * n_out
    qpos = n_out * n_out - kt2_x
    q_out = jnp.where(qpos > 0.0, jnp.sqrt(jnp.where(qpos > 0.0, qpos, 1.0)),
                      0.0)
    d_out_e = (kt_x + q_out[:, None] * (-n)) / jnp.maximum(n_out, 1e-6)[:, None]
    d_out_e = physics.normalize(d_out_e)
    cos_iw = jnp.clip(-physics.dot(k_in_hat, n), 1e-6, 1.0)
    cos_tw = jnp.clip(q_out / jnp.maximum(n_out, 1e-6), 0.0, 1.0)
    e_x_perp = _perp(c_axis, d)
    w_s_xe = physics.dot(e_x_perp, s_dir) ** 2
    rs_e, rp_e, _, _ = physics.fresnel_amplitudes(cos_iw, cos_tw,
                                                  n_wave_x, n_out)
    T_xe = jnp.where(tir_e, 0.0, jnp.clip(
        w_s_xe * (1.0 - rs_e * rs_e) + (1.0 - w_s_xe) * (1.0 - rp_e * rp_e),
        0.0, 1.0))
    # o-mode exit: sn quantities are exact (n1 = rays.ior = n_o)
    o_x_hat = physics.normalize(jnp.cross(c_axis, d))
    o_x_ok = jnp.sum(jnp.cross(c_axis, d) ** 2, axis=1) > 1e-12
    o_x_hat = jnp.where(o_x_ok[:, None], o_x_hat, s_dir)
    w_s_xo = physics.dot(_perp(o_x_hat, d), s_dir) ** 2
    T_xo = _eigen_T(sn["cos_t"], n1, n_out, w_s_xo, sn["tir"])
    T_x = jnp.where(is_e, T_xe, T_xo)
    d_out = jnp.where(is_e[:, None], d_out_e, sn["refr_dir"])
    # internally reflected same-mode child (slot B): o mirrors exactly;
    # e re-solves the dispersion relation going back into the crystal
    K_r, _ = physics.uniaxial_refract_wave(kt_x, n, c_axis, safe_no, safe_ne)
    s_r, n_ray_r = physics.uniaxial_ray_direction(K_r, c_axis,
                                                  safe_no, safe_ne)
    d_refl = jnp.where(is_e[:, None], s_r, sn["refl_dir"])
    b_ior_x = jnp.where(is_e, n_ray_r, rays.ior)
    pa_x = live_p * T_x
    pb_x = live_p * (1.0 - T_x)
    eig_x = jnp.where(is_e[:, None], _perp(c_axis, d), o_x_hat)
    basis_a_x = _perp(eig_x, d_out)
    basis_b_x = _perp(eig_x, d_refl)

    # ---- merge entry/exit -----------------------------------------------
    ent = entering
    entc = ent[:, None]
    out = {
        "is_bire": is_bire,
        "pa": jnp.where(ent, pa_in, pa_x),
        "da": jnp.where(entc, k_o, d_out),
        "a_ior": jnp.where(ent, safe_no, n_out),
        "a_absorb": jnp.where(ent, attrs["absorb"], 0.0),
        "a_basis": jnp.where(entc, basis_a_in, basis_a_x),
        "pb": jnp.where(ent, pb_in, pb_x),
        "db": jnp.where(entc, s_e, d_refl),
        "b_ior": jnp.where(ent, n_ray_e, b_ior_x),
        "b_absorb": jnp.where(ent, attrs["absorb"], rays.absorb),
        "b_basis": jnp.where(entc, basis_b_in, basis_b_x),
        # entry: the externally reflected share is absorbed (see
        # docstring); exit: pa + pb == live_p exactly
        "absorbed": jnp.sum(jnp.where(
            is_bire & ent, live_p - (pa_in + pb_in), 0.0)),
    }
    return out


def _relaunch_push(rays: RayBatch, t_draw):
    """Scale-proportional nudge (C, 1) moving a child's origin off its
    parent's facet along the outgoing direction.

    An f32 hit point o + t*d carries ~(|o| + t) ulp of roundoff; when a
    scene is large (telescope-scale .zmx imports: |o| ~ 1500), that
    error exceeds the fixed cfg.eps self-intersection guard and the
    relaunched child re-hits its own facet at t ~ roundoff — the bounce
    is silently lost (observed: 6% of a Newtonian's power escaping).
    1e-6 * (|o| + t) is ~8x the worst-case rounding, yet below the
    default eps=1e-4 guard for scenes smaller than |o| ~ 100, so on
    small scenes no hit/miss decision changes (origins shift by ~1e-6
    relative — under f32 noise)."""
    return (1e-6 * (jnp.linalg.norm(rays.o, axis=1) + t_draw))[:, None]


def shade(scene: Scene, rays: RayBatch, t, tri, cfg: TraceConfig,
          attrs=None, key=None) -> ShadeOut:
    """Apply surface interaction at the nearest hit (reference:
    `reflect_refract` kernel, SURVEY.md §3). Branchless: every ray computes
    all material outcomes; masks select. `attrs` overrides the per-hit
    triangle gathers (triangle-sharded tracing). `key` is required iff
    cfg.has_diffuse (Lambertian scatter draws)."""
    C = rays.capacity
    hit_valid = (tri >= 0) & rays.alive
    safe_tri = jnp.maximum(tri, 0)
    live_p = jnp.where(rays.alive, rays.power, 0.0)

    t_draw = jnp.where(hit_valid, t, cfg.max_ray_len)
    has_volume = cfg.has_scattering or cfg.has_fluorescence
    if has_volume:
        # volume events (extension over the reference): rays inside a
        # turbid and/or fluorescent medium draw a free path ~ Exp(mu)
        # with mu = mu_s (elastic, rays.scat) + mu_f (conversion, from
        # the per-element table of the ray's current medium, active only
        # below the band edge); a path shorter than the surface distance
        # means the ray interacts mid-flight instead of reaching the
        # surface — clamp the segment to the event point and drop the
        # lane from every surface mask. Beer-Lambert/OPL/hit_point below
        # then apply to the clamped segment automatically.
        if key is None:
            raise ValueError("cfg.has_scattering/has_fluorescence require "
                             "a PRNG key (trace_step/shade key=...)")
        if cfg.has_fluorescence and scene.fluor_mu is not None:
            mid = jnp.clip(rays.medium.astype(jnp.int32), 0,
                           scene.fluor_mu.shape[0] - 1)
            f_mu = jnp.where(
                (rays.medium >= 0.0)
                & (rays.wavelength < scene.fluor_edge[mid]),
                scene.fluor_mu[mid], 0.0)
        else:
            f_mu = None
        mu_evt = rays.scat if f_mu is None else rays.scat + f_mu
        u_free = jax.random.uniform(jax.random.fold_in(key, 0x5CA7),
                                    (C,), minval=1e-7, maxval=1.0)
        s_free = -jnp.log(u_free) / jnp.maximum(mu_evt, 1e-20)
        is_scat = rays.alive & (mu_evt > 0.0) & (s_free < t_draw)
        t_draw = jnp.where(is_scat, s_free, t_draw)
        hit_valid = hit_valid & ~is_scat
        if f_mu is not None:
            # event kind: conversion with prob mu_f / mu_evt, else elastic
            u_kind = jax.random.uniform(jax.random.fold_in(key, 0x5CA9),
                                        (C,))
            is_fluor = is_scat & (u_kind * mu_evt < f_mu)
            # emission wavelength: linear interp of the medium's
            # inverse-CDF knots at a uniform quantile
            K_em = scene.fluor_icdf.shape[1]
            x_em = jax.random.uniform(jax.random.fold_in(key, 0x5CAA),
                                      (C,)) * (K_em - 1)
            i_em = jnp.clip(x_em.astype(jnp.int32), 0, K_em - 2)
            fr_em = x_em - i_em.astype(jnp.float32)
            row = scene.fluor_icdf[mid]
            lam_lo = jnp.take_along_axis(row, i_em[:, None], 1)[:, 0]
            lam_hi = jnp.take_along_axis(row, (i_em + 1)[:, None], 1)[:, 0]
            lam_em = jnp.maximum(lam_lo * (1.0 - fr_em) + lam_hi * fr_em,
                                 1e-6)
            # power factor: quantum yield x Stokes-shift photon-energy
            # ratio (capped at 1 so anti-Stokes tails cannot create power)
            f_factor = scene.fluor_qy[mid] * jnp.minimum(
                1.0, rays.wavelength / lam_em)
            g_draw = jnp.where(is_fluor, 0.0, rays.scat_g)  # isotropic
        else:
            is_fluor = None
            g_draw = rays.scat_g
        d_scat = physics.sample_henyey_greenstein(
            jax.random.fold_in(key, 0x5CA8), rays.d, g_draw)
    else:
        is_scat = is_fluor = None
        d_scat = rays.d
    if cfg.has_grin and scene.grin_a is not None:
        # gradient-index propagation (extension): rays inside a GRIN
        # medium advance by curved steps of cfg.grin_step arc length via the
        # EXACT closed-form SELFOC propagator (physics.grin_selfoc_step).
        # Farther-than-one-step from the surface: clamp the segment and
        # drop the lane from every surface mask (the continuation rides
        # slot A, like a volume-scatter event, but DETERMINISTIC). The
        # final sub-step segment reaches the surface on the straight
        # chord the intersect found, with the direction and OPL still
        # curve-integrated over it, so exit Snell sees the curved
        # direction and the LOCAL index (maintained in rays.ior).
        E_g = scene.grin_a.shape[0]
        gmid = jnp.clip(rays.medium.astype(jnp.int32), 0, E_g - 1)
        g_a = jnp.where(rays.medium >= 0.0, scene.grin_a[gmid], 0.0)
        in_grin = rays.alive & (g_a != 0.0)
        is_gstep = in_grin & (t_draw > cfg.grin_step)
        t_draw = jnp.where(is_gstep, cfg.grin_step, t_draw)
        hit_valid = hit_valid & ~is_gstep
        r_g, d_g, n_g, opl_g = physics.grin_selfoc_step(
            rays.o, rays.d, t_draw, scene.grin_center[gmid],
            scene.grin_axis[gmid], scene.grin_n0[gmid], g_a)
        if cfg.polarization:
            # Levi-Civita transport of the polarization frame along the
            # curved step: the s-direction rides the minimal rotation
            # d -> d_g; Stokes fractions are untouched (no rotation
            # about the ray — skew-path Rytov rotation emerges from the
            # composition of steps)
            basis_g = physics.parallel_transport(rays.basis, rays.d, d_g)
            basis_g = basis_g - physics.dot(basis_g, d_g)[:, None] * d_g
            basis_g = basis_g / jnp.maximum(
                jnp.linalg.norm(basis_g, axis=1, keepdims=True), 1e-20)
        else:
            basis_g = None
        seg_len = t_draw
        if cfg.grin_substeps > 1 and scene.grin_wu is not None:
            # take up to grin_substeps - 1 MORE curved steps this bounce,
            # re-checking the surface distance against only the GRIN
            # elements' own triangles (scene.grin_wu — a Tg-sized set)
            # between steps. Decisions use the same hit predicate and eps
            # as the full intersect, so while nothing foreign intrudes
            # into the medium the trajectory is identical to taking one
            # step per iteration (see TraceConfig.grin_substeps).
            gc_l = scene.grin_center[gmid]
            gx_l = scene.grin_axis[gmid]
            gn0_l = scene.grin_n0[gmid]
            h_g = jnp.float32(cfg.grin_step)

            def _substep(i, st):
                r, dd, nn, opl_a, bas, act, s_tot = st
                t_s = nearest_t_rows(r, dd, scene.grin_wu, scene.grin_wv,
                                     scene.grin_ww, cfg)
                # t_s == inf means NO grin surface ahead: the previous
                # curved step overshot the element (axial advance of a
                # bending step can exceed the straight chord's) — stop and
                # let the next full-scene intersect interact, exactly as
                # the one-step-per-iteration mode self-heals
                go = act & (t_s > h_g) & jnp.isfinite(t_s)
                r2, d2, n2, dopl = physics.grin_selfoc_step(
                    r, dd, h_g, gc_l, gx_l, gn0_l, g_a)
                if cfg.polarization:
                    b2 = physics.parallel_transport(bas, dd, d2)
                    b2 = b2 - physics.dot(b2, d2)[:, None] * d2
                    b2 = b2 / jnp.maximum(
                        jnp.linalg.norm(b2, axis=1, keepdims=True), 1e-20)
                    bas = jnp.where(go[:, None], b2, bas)
                r = jnp.where(go[:, None], r2, r)
                dd = jnp.where(go[:, None], d2, dd)
                nn = jnp.where(go, n2, nn)
                opl_a = opl_a + jnp.where(go, dopl, 0.0)
                s_tot = s_tot + jnp.where(go, h_g, 0.0)
                return (r, dd, nn, opl_a, bas, go, s_tot)

            st0 = (r_g, d_g, n_g, opl_g,
                   basis_g if basis_g is not None else d_g,  # dummy carry
                   is_gstep, t_draw)
            r_g, d_g, n_g, opl_g, bas_out, _, s_tot = jax.lax.fori_loop(
                0, cfg.grin_substeps - 1, _substep, st0)
            if basis_g is not None:
                basis_g = bas_out
            # Beer-Lambert below must see the TOTAL arc traveled, not
            # just the first sub-step
            seg_len = jnp.where(is_gstep, s_tot, t_draw)
    else:
        in_grin = is_gstep = basis_g = None
        seg_len = t_draw
    hit_point = rays.o + t_draw[:, None] * rays.d
    # optical path length through the segment just traveled (n * length);
    # both children inherit it (same hit point)
    opl_new = rays.opl + rays.ior * t_draw
    if in_grin is not None:
        # mid-medium steps end at the CURVED endpoint; OPL integrates
        # n ds (Simpson) along the curve for stepped AND final segments
        hit_point = jnp.where(is_gstep[:, None], r_g, hit_point)
        opl_new = jnp.where(in_grin, rays.opl + opl_g, opl_new)

    # Beer-Lambert bulk attenuation over the segment just traveled
    # (rays.absorb == 0 in vacuum/air -> no-op; extension over the
    # reference, which has loss only at surfaces)
    atten = jnp.exp(-rays.absorb * seg_len)
    bulk_absorbed = jnp.sum(live_p * (1.0 - atten))
    live_p = live_p * atten

    if attrs is None:
        attrs = default_hit_attrs(scene, safe_tri, cfg)
    # birefringence is polarized-model-only (the o/e split is a Stokes
    # projection); unpolarized traces absorb such hits (ledger-exact,
    # engine refuses the combination anyway)
    has_bire = (cfg.has_birefringence and cfg.polarization
                and "bire_ne" in attrs)
    mat = attrs["mat"]
    n_geom = attrs["normal"]
    # dispersive glass: Cauchy n(lambda) = A + B / lambda^2 (lambda in um);
    # B == 0 (the default) reduces to the reference's constant IOR
    wl2 = jnp.square(rays.wavelength)
    tri_ior = attrs["ior"] + attrs["ior_b"] / wl2
    if "ior_c" in attrs:
        # extended-Cauchy lambda^-4 term (Sellmeier-catalog fits)
        tri_ior = tri_ior + attrs["ior_c"] / jnp.square(wl2)
    refl = attrs["reflectivity"]
    det_id = attrs["detector_id"]
    tri_absorb = attrs["absorb"]
    d_inc, n_inc = rays.d, rays.ior
    if in_grin is not None and scene.element_id is not None:
        # entering a GRIN element: Snell against the LOCAL index at the
        # hit point, not the constant on-axis n0
        eh = jnp.clip(scene.element_id[safe_tri], 0, E_g - 1)
        a_hit = scene.grin_a[eh]
        n_hit = physics.grin_index(hit_point, scene.grin_center[eh],
                                   scene.grin_axis[eh], scene.grin_n0[eh],
                                   a_hit)
        tri_ior = jnp.where(hit_valid & (a_hit != 0.0), n_hit, tri_ior)
        # exiting (or internally reflecting): the incident direction and
        # index are the curve-propagated values at the surface
        d_inc = jnp.where(in_grin[:, None], d_g, rays.d)
        n_inc = jnp.where(in_grin, n_g, rays.ior)
    sn = physics.snell_interaction(d_inc, n_geom, n_inc, tri_ior, cfg.ior_env)

    # complex-index metal mirrors (extension): the fixed `reflectivity`
    # becomes reflectivity * R_metal(theta) on lanes with metal_n > 0
    # (validated mirror-only); elsewhere refl_eff == refl exactly. The
    # polarized branch below replaces this unpolarized R with the full
    # complex (rs, rp) Mueller block on the same lanes.
    refl_eff = refl
    if cfg.has_metals:
        is_metal = attrs["metal_n"] > 0.0
        # one complex-Fresnel evaluation serves both models: the scalar
        # R here and (under polarization) the Mueller block below
        mrs, mrp = physics.metal_rs_rp(
            sn["cos_i"], sn["n1"], attrs["metal_n"], attrs["metal_k"])
        R_metal = jnp.clip(
            0.5 * (physics._abs2(mrs) + physics._abs2(mrp)), 0.0, 1.0
        ).astype(jnp.float32)
        refl_eff = jnp.where(is_metal, refl * R_metal, refl)

    # dielectric reflectance: bare Fresnel, or the multilayer thin-film
    # R(lambda, theta) where the triangle is coated (extension over the
    # reference). Directions and medium bookkeeping are unchanged — Snell
    # n1 -> n2 holds across a thin film. This scalar branch is skipped
    # under polarization=True because coated lanes are then handled by the
    # characteristic-matrix Mueller split (physics.polarized_film_split)
    # in the polarized branch below.
    R_diel = sn["R"]
    if cfg.has_coatings and not cfg.polarization:
        cn, ch = attrs["coat_ior"], attrs["coat_thickness"]  # (C, L)
        # stacks are stored outermost-layer-first as seen from OUTSIDE the
        # element; a ray exiting the glass sees the layers in reverse
        # order (h = 0 padding is inert in any position, so flipping the
        # whole padded row is exact)
        ent = sn["entering"][:, None]
        cn = jnp.where(ent, cn, cn[:, ::-1])
        ch = jnp.where(ent, ch, ch[:, ::-1])
        L_coat = cn.shape[1]
        R_film = physics.multilayer_reflectance(
            sn["cos_i"], sn["n1"],
            [cn[:, l] for l in range(L_coat)],
            [ch[:, l] for l in range(L_coat)],
            sn["n2"], rays.wavelength)
        # under substrate TIR the stack analysis gives |r| = 1; force it
        # exactly so complex64 roundoff can't leak power into the
        # (garbage-direction) refracted slot
        R_film = jnp.where(sn["tir"], 1.0, R_film)
        # max over layers: reversal can move the live layer off column 0
        R_diel = jnp.where(jnp.max(ch, axis=1) > 0.0, R_film, R_diel)

    is_mirror = hit_valid & (mat == int(Material.MIRROR))
    is_refr = hit_valid & (mat == int(Material.REFRACTIVE))
    is_term = hit_valid & (mat == int(Material.TERMINATOR))
    is_meas = hit_valid & (mat == int(Material.MEASURE))
    is_bs = hit_valid & (mat == int(Material.BEAMSPLITTER))
    is_pol = hit_valid & (mat == int(Material.POLARIZER))
    is_wp = hit_valid & (mat == int(Material.WAVEPLATE))
    is_optic = is_pol | is_wp  # straight-through Stokes elements
    is_miss = rays.alive & ~hit_valid
    if has_volume:
        # volume-event lanes left hit_valid but did not escape — they
        # continue as slot-A children with a redrawn direction
        is_miss = is_miss & ~is_scat
    if in_grin is not None:
        # mid-medium GRIN steps likewise continue in slot A
        is_miss = is_miss & ~is_gstep

    if cfg.has_diffuse:
        # Lambertian scatterer (extension over the reference): one child,
        # cosine-weighted direction about the oriented normal, power scaled
        # by the albedo (`reflectivity`); remainder absorbed. Scattering
        # fully depolarizes (Stokes fractions reset to zero).
        if key is None:
            raise ValueError("cfg.has_diffuse requires a PRNG key "
                             "(trace_step/shade key=...)")
        is_diff = hit_valid & (mat == int(Material.DIFFUSE))
        d_diff = physics.sample_lambertian(
            jax.random.fold_in(key, 0x5D1F), sn["n"])
    else:
        is_diff = None
        d_diff = rays.d

    if cfg.has_gratings:
        is_gr = hit_valid & (mat == int(Material.GRATING))
        # reflection grating (extension): tangential wavevector shift by
        # m * lambda0 / (n_medium * period) along the groove-perpendicular
        # (element `axis` projected into the surface); m = 0 reduces to the
        # mirror direction. Evanescent orders (|t_out| > 1) are absorbed.
        # lambda0 is the VACUUM wavelength; an immersed grating sees the
        # medium wavelength lambda0 / n (rays.ior).
        nvec = sn["n"]
        g_t = attrs["axis"] - physics.dot(attrs["axis"], nvec)[:, None] * nvec
        g_t = g_t / jnp.maximum(jnp.linalg.norm(g_t, axis=1, keepdims=True),
                                1e-20)
        t_in = rays.d - physics.dot(rays.d, nvec)[:, None] * nvec
        shift = rays.wavelength / rays.ior * attrs["grating_mlp"]
        t_out = t_in + shift[:, None] * g_t
        s2_gr = jnp.sum(t_out * t_out, axis=1)
        gr_prop = s2_gr <= 1.0
        d_gr = t_out + jnp.sqrt(jnp.maximum(1.0 - s2_gr, 0.0))[:, None] * nvec
        d_gr = d_gr / jnp.maximum(
            jnp.linalg.norm(d_gr, axis=1, keepdims=True), 1e-20)
    else:
        is_gr = gr_prop = None
        d_gr = rays.d

    # child A: the reflected branch (mirror / dielectric / beamsplitter,
    # which reflects `reflectivity` of the power mirror-style), at slot i.
    # Polarizer/waveplate children also live in slot A, continuing straight
    # through (their power is set in the polarized branch below), as does
    # the grating's diffracted child (`reflectivity` = efficiency; its
    # order-m share is (1 - order0_fraction), applied below — the specular
    # 0th-order leak rides slot B like a beamsplitter's second arm).
    refl_like = is_mirror | is_bs
    if cfg.has_gratings:
        refl_like = refl_like | (is_gr & gr_prop)
    if cfg.has_diffuse:
        refl_like = refl_like | is_diff
    pa = jnp.where(
        refl_like, live_p * refl_eff,
        jnp.where(is_refr, live_p * R_diel, 0.0)
    )
    da = jnp.where(is_optic[:, None], rays.d, sn["refl_dir"])
    if cfg.has_gratings:
        da = jnp.where(is_gr[:, None], d_gr, da)
    if cfg.has_diffuse:
        da = jnp.where(is_diff[:, None], d_diff, da)

    pol_absorbed = jnp.float32(0.0)
    a_ior = rays.ior
    a_absorb = rays.absorb
    bo = None
    if cfg.polarization:
        # Stokes-Mueller path: rotate the frame into the incidence plane,
        # apply the polarized Fresnel/TIR Mueller split, re-derive the
        # children's powers and Stokes fractions (see physics.py). Lanes
        # arriving through a GRIN medium use the curve-propagated
        # incident direction and the parallel-transported frame
        b_pol = rays.basis
        if in_grin is not None and basis_g is not None:
            b_pol = jnp.where(in_grin[:, None], basis_g, rays.basis)
        s_dir = physics.incidence_s_direction(d_inc, sn["n"], b_pol)
        cos_phi = physics.dot(b_pol, s_dir)
        sin_phi = physics.dot(jnp.cross(b_pol, s_dir), d_inc)
        s1f, s2f = physics.rotate_stokes(rays.s1, rays.s2, cos_phi, sin_phi)
        S = (live_p, s1f * live_p, s2f * live_p, rays.s3 * live_p)
        (r0, r1, r2, r3), (t0, t1, t2, t3) = physics.polarized_split(
            *S, sn["cos_i"], sn["cos_t"], sn["n1"], sn["n2"], sn["tir"])
        if cfg.has_coatings:
            # coated dielectric lanes: replace the bare Fresnel Mueller
            # split with the stack's characteristic-matrix split (complex
            # rs/rp cross terms carry film AND TIR retardation; exit-side
            # rays see the layer order reversed, h = 0 pads inert)
            cnp = attrs["coat_ior"]
            chp = attrs["coat_thickness"]
            entp = sn["entering"][:, None]
            cnp = jnp.where(entp, cnp, cnp[:, ::-1])
            chp = jnp.where(entp, chp, chp[:, ::-1])
            Lc = cnp.shape[1]
            (f0, f1, f2, f3), (g0_, g1_, g2_, g3_) = \
                physics.polarized_film_split(
                    *S, sn["cos_i"], sn["n1"],
                    [cnp[:, l] for l in range(Lc)],
                    [chp[:, l] for l in range(Lc)],
                    sn["n2"], rays.wavelength)
            coated = jnp.max(chp, axis=1) > 0.0
            r0 = jnp.where(coated, f0, r0)
            r1 = jnp.where(coated, f1, r1)
            r2 = jnp.where(coated, f2, r2)
            r3 = jnp.where(coated, f3, r3)
            t0 = jnp.where(coated, g0_, t0)
            t1 = jnp.where(coated, g1_, t1)
            t2 = jnp.where(coated, g2_, t2)
            t3 = jnp.where(coated, g3_, t3)

        def frac(num, den):
            return num / jnp.maximum(den, 1e-30)

        # polarizer / waveplate: rotate the Stokes frame onto the element's
        # transmission / fast axis projected perpendicular to the ray
        ax = attrs["axis"]
        ax_perp = ax - physics.dot(ax, d_inc)[:, None] * d_inc
        ax_len = jnp.linalg.norm(ax_perp, axis=1, keepdims=True)
        ax_ok = ax_len[:, 0] > 1e-6
        ax_perp = jnp.where(ax_ok[:, None],
                            ax_perp / jnp.maximum(ax_len, 1e-20), b_pol)
        cos_e = physics.dot(b_pol, ax_perp)
        sin_e = physics.dot(jnp.cross(b_pol, ax_perp), d_inc)
        e1f, e2f = physics.rotate_stokes(rays.s1, rays.s2, cos_e, sin_e)
        f_pol = 0.5 * (1.0 + e1f)          # Malus: ideal linear polarizer
        delta = attrs["retardance"]        # linear retarder about fast axis
        w2 = e2f * jnp.cos(delta) + rays.s3 * jnp.sin(delta)
        w3 = -e2f * jnp.sin(delta) + rays.s3 * jnp.cos(delta)
        pol_absorbed = jnp.sum(
            jnp.where(is_pol, live_p * (1.0 - f_pol), 0.0))

        pa = jnp.where(refl_like, live_p * refl_eff,
                       jnp.where(is_refr, r0,
                                 jnp.where(is_pol, live_p * f_pol,
                                           jnp.where(is_wp, live_p, 0.0))))
        pb_pol = jnp.where(is_refr, t0,
                           jnp.where(is_bs, live_p * (1.0 - refl), 0.0))
        # reflected-child fractions: an ideal mirror (and the non-polarizing
        # beamsplitter's reflected arm) imposes rs = 1, rp = -1 (Mueller
        # diag(1, 1, -1, -1)) — S2 and S3 flip sign, so circular
        # polarization inverts handedness on reflection
        # grating: non-polarizing-reflection approximation (like the
        # mirror); the child frame is rebuilt perpendicular to the
        # diffracted direction (exact for in-plane diffraction)
        flip = (is_mirror | is_bs) if not cfg.has_gratings else (
            is_mirror | is_bs | is_gr)
        a_s1 = jnp.where(is_refr, frac(r1, r0), s1f)
        a_s2 = jnp.where(is_refr, frac(r2, r0),
                         jnp.where(flip, -s2f, s2f))
        a_s3 = jnp.where(is_refr, frac(r3, r0),
                         jnp.where(flip, -rays.s3, rays.s3))
        # polarizer output is fully polarized along its axis; the waveplate
        # applies the retarder Mueller in its fast-axis frame
        a_s1 = jnp.where(is_pol, 1.0, jnp.where(is_wp, e1f, a_s1))
        a_s2 = jnp.where(is_pol, 0.0, jnp.where(is_wp, w2, a_s2))
        a_s3 = jnp.where(is_pol, 0.0, jnp.where(is_wp, w3, a_s3))
        if cfg.has_metals:
            # metal mirror lanes: full complex (rs, rp) Mueller block in
            # the rotated frame replaces the ideal-mirror flip — power,
            # diattenuation, AND metallic retardation; the scalar `refl`
            # factor still applies uniformly (amplitudes computed once,
            # above)
            m0, m1, m2, m3 = physics.mueller_reflect(*S, mrs, mrp)
            is_mm = is_mirror & is_metal
            pa = jnp.where(is_mm, refl * m0, pa)
            a_s1 = jnp.where(is_mm, frac(m1, m0), a_s1)
            a_s2 = jnp.where(is_mm, frac(m2, m0), a_s2)
            a_s3 = jnp.where(is_mm, frac(m3, m0), a_s3)
        # transmitted fractions: beamsplitter passes the rotated state;
        # the grating's slot-B child is the specular 0th order — mirror
        # Mueller (rs = 1, rp = -1): s2/s3 flip
        b_s1 = jnp.where(is_bs, s1f, frac(t1, t0))
        b_s2 = jnp.where(is_bs, s2f, frac(t2, t0))
        b_s3 = jnp.where(is_bs, rays.s3, frac(t3, t0))
        if cfg.has_gratings:
            b_s1 = jnp.where(is_gr, s1f, b_s1)
            b_s2 = jnp.where(is_gr, -s2f, b_s2)
            b_s3 = jnp.where(is_gr, -rays.s3, b_s3)
        new_basis = jnp.where(is_optic[:, None], ax_perp,
                              jnp.where(hit_valid[:, None], s_dir,
                                        rays.basis))
        if cfg.has_gratings:
            gr_basis = jnp.cross(nvec, d_gr)
            gr_len = jnp.linalg.norm(gr_basis, axis=1, keepdims=True)
            gr_basis = jnp.where(gr_len > 1e-6,
                                 gr_basis / jnp.maximum(gr_len, 1e-20), s_dir)
            new_basis = jnp.where(is_gr[:, None], gr_basis, new_basis)
        if cfg.has_diffuse:
            # scattering depolarizes: Stokes fractions reset, frame rebuilt
            # perpendicular to the scattered direction
            a_s1 = jnp.where(is_diff, 0.0, a_s1)
            a_s2 = jnp.where(is_diff, 0.0, a_s2)
            a_s3 = jnp.where(is_diff, 0.0, a_s3)
            diff_basis = physics.incidence_s_direction(
                d_diff, sn["n"], rays.basis)
            new_basis = jnp.where(is_diff[:, None], diff_basis, new_basis)
        if has_bire:
            # uniaxial crystal double refraction: slot A = ordinary (or
            # exit-transmitted), slot B = extraordinary (or internal
            # reflection); both children fully polarized in their
            # eigenframe
            bo = _shade_birefringent(scene, rays, sn, attrs, live_p,
                                     s_dir, hit_valid, cfg)
            ib = bo["is_bire"]
            ibc = ib[:, None]
            pa = jnp.where(ib, bo["pa"], pa)
            da = jnp.where(ibc, bo["da"], da)
            a_ior = jnp.where(ib, bo["a_ior"], a_ior)
            a_absorb = jnp.where(ib, bo["a_absorb"], a_absorb)
            a_s1 = jnp.where(ib, 1.0, a_s1)
            a_s2 = jnp.where(ib, 0.0, a_s2)
            a_s3 = jnp.where(ib, 0.0, a_s3)
            new_basis = jnp.where(ibc, bo["a_basis"], new_basis)
            pb_pol = jnp.where(ib, bo["pb"], pb_pol)
            b_s1 = jnp.where(ib, 1.0, b_s1)
            b_s2 = jnp.where(ib, 0.0, b_s2)
            b_s3 = jnp.where(ib, 0.0, b_s3)
    else:
        pb_pol = None
        a_s1 = a_s2 = a_s3 = None
    if has_volume:
        # the post-event continuation rides slot A: elastic scatter keeps
        # full power (extinction is the separate Beer-Lambert term over
        # the clamped segment); a conversion keeps QY x Stokes-shift of
        # it, re-emits at lam_em, and books the remainder as absorbed.
        # Medium unchanged (a_ior/a_absorb already default to the
        # parent's; dispersion of the host matrix across the Stokes
        # shift is neglected — rays keep the parent's medium IOR).
        p_evt = live_p
        if is_fluor is not None:
            p_evt = live_p * jnp.where(is_fluor, f_factor, 1.0)
            fluor_absorbed = jnp.sum(
                jnp.where(is_fluor, live_p - p_evt, 0.0))
            a_wl = jnp.where(is_fluor, lam_em, rays.wavelength)
        else:
            fluor_absorbed = jnp.float32(0.0)
            a_wl = rays.wavelength
        pa = jnp.where(is_scat, p_evt, pa)
        da = jnp.where(is_scat[:, None], d_scat, da)
        if cfg.polarization:
            # volume scattering depolarizes (like the Lambertian surface)
            a_s1 = jnp.where(is_scat, 0.0, a_s1)
            a_s2 = jnp.where(is_scat, 0.0, a_s2)
            a_s3 = jnp.where(is_scat, 0.0, a_s3)
            scat_basis = physics.incidence_s_direction(
                d_scat, rays.d, rays.basis)
            new_basis = jnp.where(is_scat[:, None], scat_basis, new_basis)
    else:
        fluor_absorbed = jnp.float32(0.0)
        a_wl = rays.wavelength
    if in_grin is not None:
        # the mid-medium GRIN continuation: full power, curved endpoint
        # direction, LOCAL index carried in the generic ior lane (what
        # OPL accumulation and the eventual exit Snell read)
        pa = jnp.where(is_gstep, live_p, pa)
        da = jnp.where(is_gstep[:, None], d_g, da)
        a_ior = jnp.where(is_gstep, n_g, a_ior)
        if cfg.polarization and basis_g is not None:
            # the mid-medium continuation carries the transported frame,
            # and the Stokes components stay UNROTATED relative to it
            # (parallel transport = no rotation about the ray; the
            # default child chain above had rotated them into the
            # surface s_dir frame, which is meaningless mid-medium)
            new_basis = jnp.where(is_gstep[:, None], basis_g, new_basis)
            a_s1 = jnp.where(is_gstep, rays.s1, a_s1)
            a_s2 = jnp.where(is_gstep, rays.s2, a_s2)
            a_s3 = jnp.where(is_gstep, rays.s3, a_s3)
    if cfg.has_gratings:
        # order m keeps (1 - g0) of the diffracted-side power (slot A);
        # the specular 0th-order leak g0 goes to slot B. Evanescent order
        # m: slot A is already zero (refl_like excludes it) — only the
        # 0th order propagates.
        g0 = attrs["grating_g0"]
        pa = jnp.where(is_gr, pa * (1.0 - g0), pa)
        if cfg.polarization:
            pb_pol = jnp.where(is_gr, live_p * refl * g0, pb_pol)
    if cfg.has_roughness and "rough_sigma" in attrs:
        # rough-mirror surface scatter (extension): the reflected power
        # pa (ideal/metal/polarized mirror Mueller — whatever the lanes
        # above computed) splits DETERMINISTICALLY by the Rayleigh-Rice
        # total integrated scatter into a specular child x (1 - TIS) at
        # slot A and a scattered child x TIS at slot B, whose direction
        # is an HG lobe about the specular direction folded above the
        # surface. Wavelength IN THE MEDIUM (lambda0 / n) sets the
        # roughness scale.
        if key is None:
            raise ValueError("cfg.has_roughness requires a PRNG key "
                             "(trace_step/shade key=...)")
        is_rough = is_mirror & (attrs["rough_sigma"] > 0.0)
        arg = (4.0 * jnp.pi * attrs["rough_sigma"] * sn["cos_i"]
               * rays.ior / rays.wavelength)
        tis = 1.0 - jnp.exp(-arg * arg)
        d_lobe = physics.sample_henyey_greenstein(
            jax.random.fold_in(key, 0x70F5), sn["refl_dir"],
            jnp.where(is_rough, attrs["rough_g"], 0.0))
        # fold below-horizon draws back above the surface (energy
        # preserving; sn["n"] is the normal oriented against the ray)
        d_dot = physics.dot(d_lobe, sn["n"])
        d_lobe = d_lobe - 2.0 * jnp.minimum(d_dot, 0.0)[:, None] * sn["n"]
        rough_b = jnp.where(is_rough, pa * tis, 0.0)  # (C,) slot-B power
        pa = jnp.where(is_rough, pa * (1.0 - tis), pa)
        if cfg.polarization:
            pb_pol = jnp.where(is_rough, rough_b, pb_pol)
    else:
        is_rough = None
        rough_b = jnp.zeros_like(live_p)
        d_lobe = rays.d
    dropped_power = jnp.zeros_like(live_p)
    if cfg.track_paths:
        # ghost/stray-light signatures: slot-A children (reflected /
        # continuing branch) append digit 1 + 2 e, slot-B children
        # (transmitted branch) 2 + 2 e, in base cfg.path_base = 2 E + 1
        # (f32-exact while path_base^bounces < 2^24)
        elem = jnp.maximum(scene.element_id[safe_tri], 0).astype(jnp.float32)
        path_a = rays.path * jnp.float32(cfg.path_base) + (1.0 + 2.0 * elem)
        path_b = rays.path * jnp.float32(cfg.path_base) + (2.0 + 2.0 * elem)
        if has_volume:
            # a volume event is not a surface interaction: the
            # continuation keeps its parent's signature unchanged
            path_a = jnp.where(is_scat, rays.path, path_a)
        if in_grin is not None:
            path_a = jnp.where(is_gstep, rays.path, path_a)
    else:
        path_a = path_b = rays.path
    if cfg.allow_splitting:
        # child B at slot C + i: refracted branch (dielectric) or the
        # straight-through transmitted branch (beamsplitter: direction and
        # medium unchanged)
        if cfg.polarization:
            pb = pb_pol
        else:
            pb = jnp.where(is_refr, live_p * (1.0 - R_diel),
                           jnp.where(is_bs, live_p * (1.0 - refl), 0.0))
            if cfg.has_gratings:
                pb = jnp.where(is_gr, live_p * refl * attrs["grating_g0"],
                               pb)
        db = jnp.where(is_bs[:, None], rays.d, sn["refr_dir"])
        b_ior = jnp.where(is_bs, rays.ior, sn["new_ior"])
        # refracted child changes medium: entering -> element's bulk
        # absorption, exiting -> ambient (0); beamsplitter stays in medium
        refr_absorb = jnp.where(is_bs, rays.absorb,
                                jnp.where(sn["entering"], tri_absorb, 0.0))
        if cfg.has_gratings:
            # grating slot B: the specular 0th order — mirror direction,
            # medium unchanged
            db = jnp.where(is_gr[:, None], sn["refl_dir"], db)
            b_ior = jnp.where(is_gr, rays.ior, b_ior)
            refr_absorb = jnp.where(is_gr, rays.absorb, refr_absorb)
        if bo is not None:
            # birefringent slot B: extraordinary child on entry, internal
            # same-mode reflection on exit
            ib = bo["is_bire"]
            db = jnp.where(ib[:, None], bo["db"], db)
            b_ior = jnp.where(ib, bo["b_ior"], b_ior)
            refr_absorb = jnp.where(ib, bo["b_absorb"], refr_absorb)
        if is_rough is not None:
            # rough-mirror slot B: the TIS-scattered child — HG lobe
            # direction, same medium as the parent
            if not cfg.polarization:
                pb = jnp.where(is_rough, rough_b, pb)
            db = jnp.where(is_rough[:, None], d_lobe, db)
            b_ior = jnp.where(is_rough, rays.ior, b_ior)
            refr_absorb = jnp.where(is_rough, rays.absorb, refr_absorb)
        # medium scattering columns travel exactly like `absorb`: slot A
        # stays in the parent's medium; the refracted child picks up the
        # element's bulk (scat_mu, scat_g) on entry and the clear ambient
        # on exit. When scattering is off the columns are inert zeros.
        a_scat, a_scat_g = rays.scat, rays.scat_g
        if cfg.has_scattering and "scat_mu" in attrs:
            refr_scat = jnp.where(
                is_bs, rays.scat,
                jnp.where(sn["entering"], attrs["scat_mu"], 0.0))
            refr_scat_g = jnp.where(
                is_bs, rays.scat_g,
                jnp.where(sn["entering"], attrs["scat_g"], 0.0))
            if cfg.has_gratings:
                refr_scat = jnp.where(is_gr, rays.scat, refr_scat)
                refr_scat_g = jnp.where(is_gr, rays.scat_g, refr_scat_g)
            if bo is not None:
                # crystals cannot be turbid (mesh validation): both
                # birefringent children are clear
                refr_scat = jnp.where(bo["is_bire"], 0.0, refr_scat)
                refr_scat_g = jnp.where(bo["is_bire"], 0.0, refr_scat_g)
            if is_rough is not None:
                # the rough mirror's scattered child stays in its medium
                refr_scat = jnp.where(is_rough, rays.scat, refr_scat)
                refr_scat_g = jnp.where(is_rough, rays.scat_g, refr_scat_g)
        else:
            refr_scat, refr_scat_g = rays.scat, rays.scat_g
        # current-medium element id travels the same way: slot A stays in
        # the parent's medium; the refracted child records the element it
        # enters (or -1 on exit to ambient). Only maintained when
        # fluorescence needs it — the column is inert -1 otherwise
        if ((cfg.has_fluorescence or cfg.has_grin)
                and scene.element_id is not None):
            elem_f = scene.element_id[safe_tri].astype(jnp.float32)
            refr_med = jnp.where(
                is_bs, rays.medium,
                jnp.where(sn["entering"], elem_f, -1.0))
            if cfg.has_gratings:
                refr_med = jnp.where(is_gr, rays.medium, refr_med)
            if bo is not None:
                refr_med = jnp.where(bo["is_bire"], -1.0, refr_med)
            if is_rough is not None:
                refr_med = jnp.where(is_rough, rays.medium, refr_med)
        else:
            refr_med = rays.medium
        push = _relaunch_push(rays, t_draw)
        child_o = jnp.concatenate(
            [hit_point + push * da, hit_point + push * db], axis=0)
        child_d = jnp.concatenate([da, db], axis=0)
        child_power = jnp.concatenate([pa, pb], axis=0)
        child_ior = jnp.concatenate([a_ior, b_ior], axis=0)
        # slot A carries the (possibly fluorescence-converted) wavelength;
        # slot B is a surface child and keeps the parent's
        child_wl = jnp.concatenate([a_wl, rays.wavelength], axis=0)
        child_ab = jnp.concatenate([a_absorb, refr_absorb], axis=0)
        # the relaunch push IS traveled path: fold it into the child's
        # OPL (in the child's medium) so ToF/coherence stay exact
        child_opl = jnp.concatenate([opl_new + push[:, 0] * a_ior,
                                     opl_new + push[:, 0] * b_ior], axis=0)
        child_path = jnp.concatenate([path_a, path_b], axis=0)
        child_scat = jnp.concatenate([a_scat, refr_scat], axis=0)
        child_scat_g = jnp.concatenate([a_scat_g, refr_scat_g], axis=0)
        child_medium = jnp.concatenate([rays.medium, refr_med], axis=0)
        if cfg.polarization:
            # slot B frame: the grating's specular child lives in the
            # incidence frame (s_dir, perpendicular to the mirror
            # direction), not the diffracted child's rebuilt frame
            b_basis = new_basis
            if cfg.has_gratings:
                b_basis = jnp.where(is_gr[:, None], s_dir, b_basis)
            if bo is not None:
                b_basis = jnp.where(bo["is_bire"][:, None], bo["b_basis"],
                                    b_basis)
            if is_rough is not None:
                # the rough mirror's scattered child is depolarized,
                # frame rebuilt perpendicular to the lobe direction
                b_s1 = jnp.where(is_rough, 0.0, b_s1)
                b_s2 = jnp.where(is_rough, 0.0, b_s2)
                b_s3 = jnp.where(is_rough, 0.0, b_s3)
                rough_basis = physics.incidence_s_direction(
                    d_lobe, sn["n"], rays.basis)
                b_basis = jnp.where(is_rough[:, None], rough_basis, b_basis)
            child_s1 = jnp.concatenate([a_s1, b_s1])
            child_s2 = jnp.concatenate([a_s2, b_s2])
            child_s3 = jnp.concatenate([a_s3, b_s3])
            child_basis = jnp.concatenate([new_basis, b_basis], axis=0)
        else:
            child_s1 = jnp.concatenate([rays.s1, rays.s1])
            child_s2 = jnp.concatenate([rays.s2, rays.s2])
            child_s3 = jnp.concatenate([rays.s3, rays.s3])
            child_basis = jnp.concatenate([rays.basis, rays.basis], axis=0)
    else:
        # no refractive elements in the scene (engine-verified): only the
        # reflected branch exists, children stay in their parent slots and
        # the 2C buffer + compaction gather are skipped entirely
        push = _relaunch_push(rays, t_draw)
        child_o = hit_point + push * da
        child_d, child_power, child_ior = da, pa, a_ior
        child_wl = a_wl
        child_ab = a_absorb
        child_opl = opl_new + push[:, 0] * a_ior
        child_path = path_a
        child_scat, child_scat_g = rays.scat, rays.scat_g
        child_medium = rays.medium
        # direct step-level users can reach this path with refractive or
        # beamsplitter triangles present (the engine forbids it); account
        # the dropped transmitted power so the ledger still balances. The
        # polarized path must use the polarized transmitted power (pb_pol),
        # not the unpolarized Fresnel split, or conservation breaks by
        # (R_pol - R_unpol) per ray.
        if cfg.polarization:
            dropped_power = pb_pol
        else:
            dropped_power = jnp.where(
                is_refr, live_p * (1.0 - R_diel),
                jnp.where(is_bs, live_p * (1.0 - refl), 0.0))
            if cfg.has_gratings:
                dropped_power = dropped_power + jnp.where(
                    is_gr, live_p * refl * attrs["grating_g0"], 0.0)
            # rough mirrors' scattered share has no slot either
            dropped_power = dropped_power + rough_b
        if cfg.polarization:
            child_s1, child_s2, child_s3 = a_s1, a_s2, a_s3
            child_basis = new_basis
        else:
            child_s1, child_s2, child_s3 = rays.s1, rays.s2, rays.s3
            child_basis = rays.basis
    child_alive = child_power > 0.0

    # mirror absorption is the reflectivity deficit: live - specular - any
    # rough-scattered share (rough_b is identically zero when roughness
    # is off, so the classic live_p - pa stands)
    absorbed = bulk_absorbed + fluor_absorbed + jnp.sum(
        jnp.where(is_term, live_p, 0.0)
    ) + jnp.sum(jnp.where(is_mirror, live_p - pa - rough_b, 0.0))
    if cfg.has_diffuse:
        absorbed = absorbed + jnp.sum(
            jnp.where(is_diff, live_p * (1.0 - refl), 0.0))
    if cfg.has_gratings:
        # (1 - refl) always lost; an evanescent order m additionally loses
        # its (1 - g0) share of the reflected power (the 0th-order leak
        # propagates regardless)
        absorbed = absorbed + jnp.sum(
            jnp.where(is_gr,
                      live_p * (1.0 - refl)
                      + jnp.where(gr_prop, 0.0,
                                  live_p * refl
                                  * (1.0 - attrs["grating_g0"])),
                      0.0))
    if cfg.polarization:
        absorbed = absorbed + pol_absorbed
        if bo is not None:
            # birefringent entry: the externally reflected share (no third
            # child slot) is accounted as absorbed
            absorbed = absorbed + bo["absorbed"]
    else:
        # polarizer/waveplate/birefringent act on Stokes state, which the
        # unpolarized model does not carry: the engine refuses such
        # scenes; direct step users get full absorption so the ledger
        # still balances
        absorbed = absorbed + jnp.sum(jnp.where(is_optic, live_p, 0.0))
    if bo is None:
        # birefringent hits with the branch disabled (unpolarized model,
        # or has_birefringence=False override): no child carries power —
        # absorb so the ledger still balances
        absorbed = absorbed + jnp.sum(jnp.where(
            hit_valid & (mat == int(Material.BIREFRINGENT)), live_p, 0.0))
    escaped_power = jnp.where(is_miss, live_p, 0.0)
    escaped = jnp.sum(escaped_power)
    measured_power = jnp.where(is_meas, live_p, 0.0)

    return ShadeOut(
        child_o, child_d, child_power, child_ior, child_wl, child_ab,
        jnp.sum(dropped_power),
        child_s1, child_s2, child_s3, child_basis, child_opl,
        child_alive,
        hit_point, is_meas, measured_power, det_id,
        absorbed, escaped,
        escaped_power, dropped_power, child_path,
        child_scat, child_scat_g, child_medium,
        atten,
    )


# --------------------------------------------------------------------------
# Detector accumulation
# --------------------------------------------------------------------------

def accumulate_detector_arrays(det: DetectorState, hit_point, dirs,
                               measured_power, det_id,
                               cfg: TraceConfig, opl=None,
                               wavelength=None, tri=None,
                               incident_power=None) -> DetectorState:
    """Scatter-add measured power into the (azimuth x polar) histogram,
    per-detector totals, and the optional planar image, from bare arrays:
    hit_point (C, 3), dirs (C, 3) arrival directions, measured_power (C,)
    (zero on unmeasured slots), det_id (C,) i32. Shared by the scalar
    shade epilogue (accumulate_detector) and the wavelength-parallel
    spectral path, which bins row-total power through the same code.

    With cfg.coherent (and opl/wavelength (C,) provided), additionally
    scatter-adds the complex field amplitude sqrt(P) e^{i 2 pi OPL/lambda}
    of each measured ray into det.image_amp — |A|^2 per pixel is the
    interference pattern (see TraceConfig.coherent)."""
    n_az, n_pol = det.hist.shape
    if cfg.hist_mode == "direction":
        v = dirs
    else:  # 'position': far-field direction of the hit point as seen from
        # cfg.hist_center (default origin; set it for off-origin domes)
        v = physics.normalize(
            hit_point - jnp.asarray(cfg.hist_center, jnp.float32))
    az = jnp.arctan2(v[:, 1], v[:, 0])  # [-pi, pi)
    az = jnp.where(az < 0, az + 2.0 * np.pi, az)
    pol = jnp.arccos(jnp.clip(v[:, 2], -1.0, 1.0))
    ia = jnp.clip((az / (2.0 * np.pi) * n_az).astype(jnp.int32), 0, n_az - 1)
    ip = jnp.clip((pol / np.pi * n_pol).astype(jnp.int32), 0, n_pol - 1)
    flat = ia * n_pol + ip
    did = jnp.clip(det_id, 0, det.per_detector.shape[0] - 1)
    hist = det.hist.reshape(-1).at[flat].add(
        measured_power).reshape(n_az, n_pol)
    per_det = det.per_detector.at[did].add(measured_power)

    image = det.image
    image_amp = det.image_amp
    if cfg.image_bins > 0:
        # planar intensity map: project measured hit points onto the image
        # plane's (u, v) frame and scatter-add power into the pixel grid
        nb = cfg.image_bins
        flat_img = image_flat_indices(hit_point, cfg)
        do_coh = cfg.coherent and opl is not None and wavelength is not None
        image = jnp.pad(image.reshape(-1), (0, 1)).at[flat_img].add(
            measured_power
        )[:-1].reshape(nb, nb)
        if do_coh:
            re, im = coherent_amplitudes(measured_power, opl, wavelength)
            pad_amp = jnp.pad(image_amp.reshape(2, -1), ((0, 0), (0, 1)))
            pad_amp = pad_amp.at[0, flat_img].add(re)
            pad_amp = pad_amp.at[1, flat_img].add(im)
            image_amp = pad_amp[:, :-1].reshape(image_amp.shape)

    time_hist = det.time_hist
    if cfg.time_bins > 0 and opl is not None:
        # time-of-flight: bin measured power by arrival OPL, per detector.
        # Out-of-range arrivals clamp into the edge bins so the histogram
        # total stays exactly the measured power.
        nt = time_hist.shape[1]
        span = max(cfg.opl_max - cfg.opl_min, 1e-30)
        it = jnp.clip(((opl - cfg.opl_min) / span * nt).astype(jnp.int32),
                      0, nt - 1)
        flat_t = did * nt + it
        time_hist = time_hist.reshape(-1).at[flat_t].add(
            measured_power).reshape(time_hist.shape)

    tri_flux = det.tri_flux
    if cfg.flux_map and tri is not None and incident_power is not None:
        # per-facet incident-flux map: scatter the ARRIVING parent power at
        # the hit triangle (misses carry tri == -1 -> routed to the dropped
        # pad slot). tri_flux is sized to the scene's padded count by the
        # engine, so valid hits always land in range.
        T = tri_flux.shape[0]
        idx = jnp.where(tri >= 0, tri, T)
        tri_flux = jnp.pad(tri_flux, (0, 1)).at[idx].add(
            incident_power, mode="drop")[:-1]
    return DetectorState(hist, per_det, image, image_amp, tri_flux,
                         time_hist)


def image_flat_indices(hit_point, cfg: TraceConfig):
    """(C,) flat pixel index of each hit on the cfg image plane; points
    outside the grid map to the drop slot nb * nb (callers pad by one).
    Shared by the incoherent/coherent image scatters and the spectral
    per-wavelength coherent planes."""
    from lightpycl_tpu.sources import _frame

    F = jnp.asarray(_frame(cfg.image_normal), jnp.float32)
    rel = hit_point - jnp.asarray(cfg.image_center, jnp.float32)
    # elementwise dot, NOT a matmul: a default-precision f32 matmul may
    # run in TF32 and truncate geometry (see CLAUDE.md)
    x = jnp.sum(rel * F[0], axis=1)
    y = jnp.sum(rel * F[1], axis=1)
    nb = cfg.image_bins
    hw = cfg.image_halfwidth
    # floor, not int-cast: truncation would alias points just outside
    # the left/bottom edge into row/column 0
    ix = jnp.floor((x + hw) / (2 * hw) * nb).astype(jnp.int32)
    iy = jnp.floor((y + hw) / (2 * hw) * nb).astype(jnp.int32)
    inside = (ix >= 0) & (ix < nb) & (iy >= 0) & (iy < nb)
    return jnp.where(inside, ix * nb + iy, nb * nb)


def coherent_amplitudes(measured_power, opl, wavelength):
    """(re, im) of sqrt(P) e^{i 2 pi OPL / lambda} per ray. Phase from the
    FRACTIONAL part of OPL/lambda: whole waves drop out, so f32 keeps
    sub-wave precision over path lengths thousands of waves long."""
    amp = jnp.sqrt(jnp.maximum(measured_power, 0.0))
    turns = opl / wavelength
    phase = 2.0 * np.pi * (turns - jnp.floor(turns))
    return amp * jnp.cos(phase), amp * jnp.sin(phase)


def accumulate_detector(det: DetectorState, sh: ShadeOut, rays: RayBatch,
                        cfg: TraceConfig, tri=None) -> DetectorState:
    """Scatter-add measured power into the (azimuth x polar) histogram and
    per-detector totals (reference: measurement-surface collection +
    directivity binning, SURVEY.md §3/§4.4 — moved on-device). `tri` is the
    intersect result (hit triangle per parent), consumed only by the
    cfg.flux_map per-facet incident-power map."""
    C = sh.hit_point.shape[0]
    inc = None
    if cfg.flux_map and tri is not None:
        # arriving power = start-of-segment power x Beer-Lambert bulk
        # transmission over the segment (sh.atten == 1 outside absorbing
        # media), matching the power shade hands every other consumer
        inc = jnp.where((tri >= 0) & rays.alive,
                        rays.power * sh.atten, 0.0)
    return accumulate_detector_arrays(det, sh.hit_point, rays.d,
                                      sh.measured_power, sh.det_id, cfg,
                                      opl=sh.child_opl[:C],
                                      wavelength=rays.wavelength,
                                      tri=tri, incident_power=inc)


# --------------------------------------------------------------------------
# Compaction
# --------------------------------------------------------------------------

def roulette(sh: ShadeOut, cfg: TraceConfig, key):
    """Russian-roulette termination (opt-in, cfg.roulette_threshold > 0):
    children with 0 < power < threshold survive with probability
    power/threshold and are boosted to exactly threshold — unbiased in
    expectation, unlike the reference's power-cutoff cull which silently
    biases detected power low. The per-sample power delta (kills minus
    boosts) is accounted in 'culled' (can be negative) so the conservation
    ledger stays exact per run."""
    thr = cfg.roulette_threshold
    weak = sh.child_alive & (sh.child_power < thr)
    p_survive = jnp.clip(sh.child_power / thr, 0.0, 1.0)
    u = jax.random.uniform(key, sh.child_power.shape)
    survive = u < p_survive
    new_power = jnp.where(weak, jnp.where(survive, thr, 0.0), sh.child_power)
    delta = jnp.sum(jnp.where(weak, sh.child_power - new_power, 0.0))
    return sh._replace(child_power=new_power,
                       child_alive=sh.child_alive & (new_power > 0.0)), delta


def compact(sh: ShadeOut, capacity: int, cfg: TraceConfig):
    """Fit the live children back into `capacity` slots (reference:
    host-side numpy compaction, SURVEY.md §4.3 — here fully on-device).
    Returns (RayBatch, culled_power); dropped/below-cutoff power is
    accounted so the conservation ledger stays exact.

    Three statically-selected strategies (cfg):
      * no-split scenes: children sit in their parent slots — no gather
      * 'topk':   keep the `capacity` highest-power live children (sort)
      * 'stream': cumsum scatter, O(C); drops by slot order on overflow
    """
    live = sh.child_alive & (sh.child_power > cfg.power_cutoff)
    below = jnp.sum(jnp.where(sh.child_alive & ~live, sh.child_power, 0.0))

    if not cfg.allow_splitting:
        power = jnp.where(live, sh.child_power, 0.0)
        rays = RayBatch(sh.child_o, sh.child_d, power, sh.child_ior, live,
                        sh.child_wavelength, sh.child_absorb,
                        sh.child_s1, sh.child_s2, sh.child_s3, sh.child_basis,
                        sh.child_opl, sh.child_path,
                        sh.child_scat, sh.child_scat_g, sh.child_medium)
        return rays, below

    total_live = jnp.sum(jnp.where(live, sh.child_power, 0.0))
    if cfg.compaction == "stream":
        pos = jnp.cumsum(live.astype(jnp.int32)) - 1
        slot = jnp.where(live & (pos < capacity), pos, capacity)

        def scat(a, fill=0.0):
            buf = jnp.full((capacity + 1,) + a.shape[1:], fill, a.dtype)
            return buf.at[slot].set(a, mode="drop")[:capacity]

        o = scat(sh.child_o)
        d = scat(sh.child_d, fill=1.0)
        power = scat(sh.child_power)
        ior = scat(sh.child_ior, fill=1.0)
        wl = scat(sh.child_wavelength, fill=1.0)
        ab = scat(sh.child_absorb)
        ps1, ps2, ps3 = (scat(x) for x in (sh.child_s1, sh.child_s2, sh.child_s3))
        pbasis = scat(sh.child_basis)
        popl = scat(sh.child_opl)
        ppath = scat(sh.child_path)
        pscat = scat(sh.child_scat)
        pscat_g = scat(sh.child_scat_g)
        pmed = scat(sh.child_medium, fill=-1.0)
        alive = scat(live, fill=False)
        rays = RayBatch(o, d, power, ior, alive, wl, ab, ps1, ps2, ps3,
                        pbasis, popl, ppath, pscat, pscat_g, pmed)
        culled = total_live - jnp.sum(power) + below
        return rays, culled

    key = jnp.where(live, sh.child_power, -1.0)
    _, idx = jax.lax.top_k(key, capacity)
    sel_live = live[idx]
    sel_power = jnp.where(sel_live, sh.child_power[idx], 0.0)
    culled = total_live - jnp.sum(sel_power) + below
    rays = RayBatch(
        o=sh.child_o[idx],
        d=sh.child_d[idx],
        power=sel_power,
        ior=sh.child_ior[idx],
        alive=sel_live,
        wavelength=sh.child_wavelength[idx],
        absorb=sh.child_absorb[idx],
        s1=sh.child_s1[idx],
        s2=sh.child_s2[idx],
        s3=sh.child_s3[idx],
        basis=sh.child_basis[idx],
        opl=sh.child_opl[idx],
        path=sh.child_path[idx],
        scat=sh.child_scat[idx],
        scat_g=sh.child_scat_g[idx],
        medium=sh.child_medium[idx],
    )
    return rays, culled


# --------------------------------------------------------------------------
# Full step + on-device multi-bounce loop
# --------------------------------------------------------------------------

class StepAux(NamedTuple):
    """Per-iteration observables for harvest/plot modes (host loop only).

    Measured rays are compacted on-device into the FRONT of the m_* arrays
    (first `measured_count` entries) so the host transfers only the
    measured slice, not full-capacity buffers (the reference reads back
    everything every iteration — SURVEY.md §4.3)."""

    hit_point: jnp.ndarray       # (C, 3) segment endpoints (for paths/plots)
    start_point: jnp.ndarray     # (C, 3) segment starts (POST-reorder when
                                 # cfg.cull sorts rays; pairs with hit_point)
    parent_alive: jnp.ndarray    # (C,) bool parents that were traced
    m_pos: jnp.ndarray           # (C, 3) measured hit points, compacted
    m_dir: jnp.ndarray           # (C, 3) arrival directions, compacted
    m_power: jnp.ndarray         # (C,) measured powers, compacted
    m_det: jnp.ndarray           # (C,) detector ids, compacted
    m_wl: jnp.ndarray            # (C,) wavelengths [um], compacted
    m_stokes: jnp.ndarray        # (C,3) Stokes fractions, compacted
    m_opl: jnp.ndarray           # (C,) optical path lengths, compacted
    m_path: jnp.ndarray          # (C,) path signatures, compacted
    #   (the measured PARENT's chain up to this hit; the detector element
    #   itself is identified by m_det, not appended to the signature)
    measured_count: jnp.ndarray  # () i32
    live_count: jnp.ndarray      # () i32 live rays AFTER the step


def merge_analytic(scene: Scene, o, d, t, tri, cfg: TraceConfig):
    """Merge the exact quadric nearest hits (geometry/analytic.py,
    ops/quadric.py) into a triangle-intersect result. The winning
    surface's attribute row is its placeholder triangle's, so the full
    material model downstream is untouched — only the geometric normal
    must be overridden with the exact quadric gradient.

    Returns (t, tri, quad_hit) where quad_hit is None when the scene has
    no analytic surfaces (or the branch is gated off), else
    (use_q (C,) bool, nq (C, 3) exact normals) for the caller to apply:
    attrs["normal"] = where(use_q, nq, attrs["normal"]). Shared by
    trace_step and both spectral loops (spectral.py) so analytic lenses
    behave identically in every trace mode."""
    if not (cfg.has_analytic
            and getattr(scene, "quad_abgd", None) is not None):
        return t, tri, None
    from lightpycl_tpu.ops.quadric import intersect_quadrics

    tq, qtri, nq = intersect_quadrics(scene, o, d, cfg)
    use_q = tq < t
    return (jnp.where(use_q, tq, t), jnp.where(use_q, qtri, tri),
            (use_q, nq))


def trace_step(scene: Scene, rays: RayBatch, det: DetectorState, led: Ledger,
               cfg: TraceConfig, key=None):
    """One bounce: (reorder,) intersect, shade, measure, (roulette,)
    compact. `key` is only needed when cfg.needs_rng (roulette and/or
    Lambertian scattering)."""
    if cfg.cull:
        rays = reorder_rays(scene, rays)
    t, tri = intersect(scene, rays.o, rays.d, cfg, alive=rays.alive)
    t, tri, quad_hit = merge_analytic(scene, rays.o, rays.d, t, tri, cfg)
    attrs = None
    if quad_hit is not None:
        use_q, nq = quad_hit
        attrs = default_hit_attrs(scene, jnp.maximum(tri, 0), cfg)
        attrs["normal"] = jnp.where(use_q[:, None], nq, attrs["normal"])
    sh = shade(scene, rays, t, tri, cfg, attrs=attrs, key=key)
    det = accumulate_detector(det, sh, rays, cfg, tri=tri)
    rr_delta = jnp.float32(0.0)
    if cfg.roulette_threshold > 0.0:
        if key is None:
            raise ValueError("roulette_threshold > 0 requires a PRNG key")
        sh, rr_delta = roulette(sh, cfg, key)
    new_rays, culled = compact(sh, rays.capacity, cfg)
    culled = culled + rr_delta + sh.policy_dropped
    led = Ledger(
        emitted=led.emitted,
        measured=led.measured + jnp.sum(sh.measured_power),
        absorbed=led.absorbed + sh.absorbed,
        escaped=led.escaped + sh.escaped,
        culled=led.culled + culled,
    )
    # stream-compact measured rays to the array front with ONE fused
    # (C, 14) cumsum scatter instead of one scatter per field. det_id
    # rides along as f32 (exact below
    # 2^24 detectors); device mode never pays any of this (aux is dead
    # code there and XLA removes it).
    C = rays.capacity
    midx = jnp.cumsum(sh.measured.astype(jnp.int32)) - 1
    slot = jnp.where(sh.measured, midx, C)  # C = out-of-range -> dropped
    m_count = jnp.sum(sh.measured.astype(jnp.int32))
    stacked = jnp.concatenate(
        [sh.hit_point, rays.d, sh.measured_power[:, None],
         rays.wavelength[:, None], rays.s1[:, None], rays.s2[:, None],
         rays.s3[:, None], sh.det_id.astype(jnp.float32)[:, None],
         sh.child_opl[:C, None], rays.path[:, None]], axis=1)
    m = jnp.zeros((C + 1, 14), jnp.float32).at[slot].set(
        stacked, mode="drop")[:C]
    m_det = jnp.where(jnp.arange(C) < m_count,
                      m[:, 11].astype(jnp.int32), -1)

    aux = StepAux(
        hit_point=sh.hit_point,
        start_point=rays.o,
        parent_alive=rays.alive,
        m_pos=m[:, 0:3],
        m_dir=m[:, 3:6],
        m_power=m[:, 6],
        m_det=m_det,
        m_wl=m[:, 7],
        m_stokes=m[:, 8:11],
        m_opl=m[:, 12],
        m_path=m[:, 13],
        measured_count=m_count,
        live_count=jnp.sum(new_rays.alive.astype(jnp.int32)),
    )
    return new_rays, det, led, aux


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(1,))
def trace_step_jit(scene: Scene, rays: RayBatch, det: DetectorState,
                   led: Ledger, cfg: TraceConfig, key=None):
    return trace_step(scene, rays, det, led, cfg, key=key)


@functools.partial(jax.jit, static_argnames=("cfg", "iterations"),
                   donate_argnums=(1,))
def trace_loop_jit(scene: Scene, rays: RayBatch, det: DetectorState,
                   led: Ledger, cfg: TraceConfig, iterations: int, key=None):
    """Whole fixed-depth trace as ONE on-device computation (the reference's
    per-iteration host round-trip removed — SURVEY.md §4.3 design note).
    Early exit when accounted power reaches cfg.dissipation_target via
    lax.while_loop over bounce index."""

    def cond(state):
        i, rays, det, led = state
        return (i < iterations) & (
            led.accounted() < cfg.dissipation_target * led.emitted
        )

    base_key = (key if key is not None else jax.random.key(cfg.seed))

    def body(state):
        i, rays, det, led = state
        k = (jax.random.fold_in(base_key, i)
             if cfg.needs_rng else None)
        rays, det, led, _ = trace_step(scene, rays, det, led, cfg, key=k)
        return (i + 1, rays, det, led)

    iters_run, rays, det, led = jax.lax.while_loop(
        cond, body, (jnp.int32(0), rays, det, led)
    )
    return rays, det, led, iters_run
