"""Scene flattening: GeoObjects -> device triangle-soup arrays.

Reference parity: the scene-flatten step of CL_Tracer.iterative_tracer
(SURVEY.md §4.3): concatenate mesh vertices with index offsets and build
per-triangle material / IOR arrays.

Design: alongside the raw (v0, e1, e2) soup we precompute, in host
float64, the per-triangle WORLD -> UNIT-TRIANGLE affine transform

    [u, v, w]^T = A_inv @ (p - v0),   A = [e1 | e2 | e1 x e2]

stored as three (T, 4) row matrices (rows of A_inv with the translation
folded in). With homogeneous ray origin O4 = [o, 1] and direction D4 =
[d, 0], the per-(ray, triangle) quantities OU/OV/OW and DU/DV/DW are plain
contractions (R,4) @ (4,T): three FMAs per plane per (ray, triangle) pair,
which is what the intersect kernel (ops/intersect_gpu.py) evaluates in
fp32, with no per-pair cross products as in Möller–Trumbore.

The hit test then reduces to:  t = -OW / DW;  u = OU + t DU;  v = OV + t DV;
hit iff DW != 0, eps < t < t_max, u >= -eps_b, v >= -eps_b, u + v <= 1+eps_b
— mathematically the same predicate Möller–Trumbore evaluates.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax.numpy as jnp
import numpy as np

from lightpycl_tpu.geometry.mesh import GeoObject
from lightpycl_tpu.materials import Material


class Scene(NamedTuple):
    """Flattened device scene (all arrays padded to T_pad triangles)."""

    v0: jnp.ndarray            # (T_pad, 3) f32
    e1: jnp.ndarray            # (T_pad, 3) f32
    e2: jnp.ndarray            # (T_pad, 3) f32
    normal: jnp.ndarray        # (T_pad, 3) f32 unit outward geometric normal
    wu: jnp.ndarray            # (T_pad, 4) f32 unit-transform row u (+offset)
    wv: jnp.ndarray            # (T_pad, 4) f32 row v
    ww: jnp.ndarray            # (T_pad, 4) f32 row w (plane row)
    mat: jnp.ndarray           # (T_pad,) i32 Material code
    ior: jnp.ndarray           # (T_pad,) f32 IOR inside the element (Cauchy A)
    ior_b: jnp.ndarray         # (T_pad,) f32 Cauchy B [um^2]: n = A + B/wl^2
    absorb: jnp.ndarray        # (T_pad,) f32 bulk absorption inside [1/len]
    reflectivity: jnp.ndarray  # (T_pad,) f32 mirror reflectivity
    detector_id: jnp.ndarray   # (T_pad,) i32 measure-surface index, -1 else
    axis: jnp.ndarray          # (T_pad, 3) f32 polarizer/waveplate/grating axis
    retardance: jnp.ndarray    # (T_pad,) f32 waveplate retardance [rad]
    grating_mlp: jnp.ndarray   # (T_pad,) f32 m / period [1/um], 0 = no grating
    grating_g0: jnp.ndarray    # (T_pad,) f32 fraction of reflected power
    #   leaking into the specular 0th order (gratings only; 0 elsewhere)
    metal_n: jnp.ndarray       # (T_pad,) f32 metal-mirror complex index:
    metal_k: jnp.ndarray       # real part n and extinction k (0 = ideal
    #   mirror with the fixed `reflectivity`)
    coat_ior: jnp.ndarray      # (T_pad, L) f32 coating-stack layer indices
    coat_thickness: jnp.ndarray  # (T_pad, L) f32 layer thicknesses [um];
    #   layer 0 outermost; rows padded with h=0 layers (exactly inert in
    #   the Airy recursion); all-zero row = bare surface. L = the scene's
    #   max stack depth (>= 1)
    ior_c: jnp.ndarray = None  # (T_pad,) f32 extended-Cauchy C [um^4]:
    #   n = A + B/wl^2 + C/wl^4 (Sellmeier-catalog fits). Optional so
    #   hand-built scenes (diff.py) stay valid — the shade term is gated
    #   on its presence
    bire_ne: jnp.ndarray = None  # (T_pad,) f32 extraordinary principal
    #   index of BIREFRINGENT elements (0 elsewhere; `ior` holds n_o and
    #   `axis` the optic axis). Optional so hand-built scenes (diff.py)
    #   stay valid — the shade branch is gated on its presence
    scat_mu: jnp.ndarray = None  # (T_pad,) f32 volume scattering
    #   coefficient mu_s of the element's BULK [1/len] (0 = clear glass);
    #   picked up by the refracted child like `absorb`. Optional like
    #   bire_ne
    scat_g: jnp.ndarray = None  # (T_pad,) f32 Henyey-Greenstein
    #   anisotropy of the element's bulk; rides with scat_mu
    rough_sigma: jnp.ndarray = None  # (T_pad,) f32 RMS micro-roughness of
    #   MIRROR surfaces [um] (0 = polished); drives the Rayleigh-Rice TIS
    #   specular/scattered split. Optional like bire_ne
    rough_g: jnp.ndarray = None  # (T_pad,) f32 HG anisotropy of the
    #   scattered lobe about the specular direction; rides with rough_sigma
    element_id: jnp.ndarray = None  # (T_pad,) i32 index into the elements
    #   list the scene was built from (-1 on padding); drives
    #   TraceConfig.track_paths ghost/stray-light signatures. Optional so
    #   hand-built scenes (diff.py) stay valid — tracking needs build_scene
    # PER-ELEMENT fluorescence tables, indexed by a ray's current-medium
    # element id (rays.medium) — unlike every per-triangle column above.
    # None when no element fluoresces. Fluorescent traces run with the
    # scene REPLICATED (host/device/multichip; the engine refuses mesh2d)
    fluor_mu: jnp.ndarray = None    # (E,) f32 conversion coefficient mu_f
    fluor_qy: jnp.ndarray = None    # (E,) f32 quantum yield in [0, 1]
    fluor_edge: jnp.ndarray = None  # (E,) f32 absorption band edge [um]
    fluor_icdf: jnp.ndarray = None  # (E, K) f32 emission inverse-CDF
    #   wavelength knots at uniform quantiles (rows of non-fluorescent
    #   elements are all-zero and never sampled)
    # PER-ELEMENT GRIN tables, indexed like the fluor_* ones (rays.medium;
    # scene replicated — the engine refuses mesh2d). None when no element
    # has a gradient profile
    grin_a: jnp.ndarray = None      # (E,) f32 parabolic coefficient A
    grin_n0: jnp.ndarray = None     # (E,) f32 on-axis index n0
    grin_center: jnp.ndarray = None  # (E, 3) f32 profile-axis point
    grin_axis: jnp.ndarray = None   # (E, 3) f32 unit profile axis
    # compact unit-transform rows of ONLY the GRIN elements' triangles
    # (zero-row padded to a chunk multiple): TraceConfig.grin_substeps > 1
    # re-intersects mid-medium rays against this tiny set instead of the
    # whole scene, so k curved sub-steps cost k x (C x Tg) instead of
    # k full (C x T) intersects
    grin_wu: jnp.ndarray = None     # (Tg_pad, 4) f32
    grin_wv: jnp.ndarray = None
    grin_ww: jnp.ndarray = None
    # ANALYTIC (exact quadric) surfaces — geometry/analytic.py. Each owns
    # one ordinary attribute row above (its placeholder triangle's, whose
    # wu/wv/ww are zeroed so the triangle path never hits it); the exact
    # intersection runs in ops/quadric.intersect_quadrics and merges with
    # the triangle nearest-hit in trace_step. None when the scene has no
    # analytic surfaces. Replicated across chips like the mesh (the
    # engine refuses mesh2d, which shards triangle columns).
    quad_abgd: jnp.ndarray = None    # (Q, 4) f32 local implicit form
    quad_rlim: jnp.ndarray = None    # (Q, 2) f32 radial hit bounds
    quad_zlim: jnp.ndarray = None    # (Q, 2) f32 axial hit bounds (local)
    quad_vertex: jnp.ndarray = None  # (Q, 3) f32 local-frame origin
    quad_frame: jnp.ndarray = None   # (Q, 3, 3) f32 rows = local axes
    quad_tri: jnp.ndarray = None     # (Q,) i32 attribute-row index

    @property
    def num_triangles_padded(self) -> int:
        return self.v0.shape[0]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _morton3_np(q: np.ndarray) -> np.ndarray:
    """Interleave 3x10-bit quantized coords into 30-bit Morton codes."""
    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    q = q.astype(np.uint32)
    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def build_scene(objects: Sequence[GeoObject], pad_to: int = 256,
                spatial_sort: bool = False) -> tuple[Scene, list[str]]:
    """Flatten optical elements into a Scene pytree.

    Returns (scene, detector_names) where detector_names[i] labels the
    measure surface with detector_id == i. Padding triangles are degenerate
    (all-zero transform rows -> DW == 0 -> never hit).

    spatial_sort reorders triangles by the Morton code of their centroids so
    the Pallas kernel's triangle tiles become compact spatial patches — this
    is what gives the conservative cull (TraceConfig.cull) small per-tile
    bounding volumes. Physics is order-independent; only internal triangle
    indices change.
    """
    if not objects:
        raise ValueError("scene needs at least one optical element")
    tv_list, mat_list, ior_list, refl_list, det_list = [], [], [], [], []
    iorb_list = []
    iorc_list = []
    absorb_list = []
    axis_list, ret_list, gr_list, g0_list = [], [], [], []
    mn_list, mk_list = [], []
    bire_list = []
    smu_list, sg_list = [], []
    rsig_list, rg_list = [], []
    coat_stacks = []  # (t, [(n, h), ...]) per element; widths equalized below
    detector_names: list[str] = []
    elem_list = []
    for i_obj, obj in enumerate(objects):
        t = obj.num_triangles
        if t == 0:
            continue
        elem_list.append(np.full(t, i_obj, np.int32))
        tv_list.append(obj.triangle_vertices())  # (t, 3, 3) f64
        mat_list.append(np.full(t, int(obj.material), np.int32))
        ior_list.append(np.full(t, float(obj.ior), np.float64))
        iorb_list.append(np.full(t, float(getattr(obj, "dispersion_b", 0.0)),
                                 np.float64))
        iorc_list.append(np.full(t, float(getattr(obj, "dispersion_c", 0.0)),
                                 np.float64))
        absorb_list.append(np.full(t, float(getattr(obj, "absorption", 0.0)),
                                   np.float64))
        refl_list.append(np.full(t, float(obj.reflectivity), np.float64))
        ax = (np.zeros(3) if getattr(obj, "axis", None) is None
              else np.asarray(obj.axis, np.float64))
        axis_list.append(np.tile(ax, (t, 1)))
        ret_list.append(np.full(t, float(getattr(obj, "retardance", 0.0)),
                                np.float64))
        period = float(getattr(obj, "grating_period", 0.0))
        mlp = (float(getattr(obj, "grating_order", 1)) / period
               if period > 0 else 0.0)
        gr_list.append(np.full(t, mlp, np.float64))
        g0_list.append(np.full(t, float(getattr(obj, "order0_fraction", 0.0))
                               if period > 0 else 0.0, np.float64))
        mn_list.append(np.full(t, float(getattr(obj, "metal_n", 0.0)),
                               np.float64))
        mk_list.append(np.full(t, float(getattr(obj, "metal_k", 0.0)),
                               np.float64))
        bire_list.append(np.full(t, float(getattr(obj, "ne", 0.0)),
                                 np.float64))
        smu_list.append(np.full(t, float(getattr(obj, "scattering", 0.0)),
                                np.float64))
        sg_list.append(np.full(t, float(getattr(obj, "scatter_g", 0.0)),
                               np.float64))
        rsig_list.append(np.full(t, float(getattr(obj, "roughness", 0.0)),
                                 np.float64))
        rg_list.append(np.full(t, float(getattr(obj, "roughness_lobe", 0.9)),
                               np.float64))
        layers = (obj.coating_layers() if hasattr(obj, "coating_layers")
                  else [])
        coat_stacks.append((t, layers))
        if obj.material == Material.MEASURE:
            det_id = len(detector_names)
            detector_names.append(obj.name or f"detector_{det_id}")
            det_list.append(np.full(t, det_id, np.int32))
        else:
            det_list.append(np.full(t, -1, np.int32))

    tv = np.concatenate(tv_list)              # (T, 3, 3)
    mat_np = np.concatenate(mat_list)
    ior_np = np.concatenate(ior_list)
    iorb_np = np.concatenate(iorb_list)
    iorc_np = np.concatenate(iorc_list)
    absorb_np = np.concatenate(absorb_list)
    refl_np = np.concatenate(refl_list)
    det_np = np.concatenate(det_list)
    axis_np = np.concatenate(axis_list)
    ret_np = np.concatenate(ret_list)
    gr_np = np.concatenate(gr_list)
    g0_np = np.concatenate(g0_list)
    mn_np = np.concatenate(mn_list)
    mk_np = np.concatenate(mk_list)
    bire_np = np.concatenate(bire_list)
    smu_np = np.concatenate(smu_list)
    sg_np = np.concatenate(sg_list)
    rsig_np = np.concatenate(rsig_list)
    rg_np = np.concatenate(rg_list)
    elem_np = np.concatenate(elem_list)
    # coating stacks, width-equalized to the scene's deepest stack (h = 0
    # padding layers are exactly inert — physics.multilayer_rs_rp)
    L_coat = max((len(layers) for _, layers in coat_stacks), default=0) or 1
    cior_np = np.concatenate([
        np.tile([n for n, _ in layers] + [1.0] * (L_coat - len(layers)),
                (t, 1))
        for t, layers in coat_stacks])
    cth_np = np.concatenate([
        np.tile([h for _, h in layers] + [0.0] * (L_coat - len(layers)),
                (t, 1))
        for t, layers in coat_stacks])
    if spatial_sort:
        c = tv.mean(axis=1)
        lo, hi = c.min(axis=0), c.max(axis=0)
        qn = np.clip((c - lo) / np.maximum(hi - lo, 1e-30) * 1023.0, 0, 1023)
        order = np.argsort(_morton3_np(qn), kind="stable")
        tv = tv[order]
        mat_np, ior_np, iorb_np = mat_np[order], ior_np[order], iorb_np[order]
        iorc_np = iorc_np[order]
        absorb_np, refl_np, det_np = (absorb_np[order], refl_np[order],
                                      det_np[order])
        axis_np, ret_np = axis_np[order], ret_np[order]
        gr_np = gr_np[order]
        g0_np = g0_np[order]
        mn_np, mk_np = mn_np[order], mk_np[order]
        bire_np = bire_np[order]
        smu_np, sg_np = smu_np[order], sg_np[order]
        rsig_np, rg_np = rsig_np[order], rg_np[order]
        cior_np, cth_np = cior_np[order], cth_np[order]
        elem_np = elem_np[order]
    T = len(tv)
    v0 = tv[:, 0]
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    n = np.cross(e1, e2)
    n_len = np.linalg.norm(n, axis=1, keepdims=True)
    ok = (n_len[:, 0] > 1e-30)
    n_unit = n / np.where(n_len > 0, n_len, 1.0)

    # unit-triangle transform rows, f64 for conditioning, then cast f32
    A = np.stack([e1, e2, n], axis=2)         # (T, 3, 3) columns e1|e2|n
    rows = np.zeros((T, 3, 4))
    if ok.any():
        A_inv = np.linalg.inv(A[ok])
        b = -np.einsum("tij,tj->ti", A_inv, v0[ok])
        rows[ok, :, :3] = A_inv
        rows[ok, :, 3] = b

    # analytic quadric surfaces: zero their placeholder triangles' transform
    # rows (the padding mechanism — DW == 0 never hits) and record which
    # attribute row each surface owns; ops/quadric.py intersects them
    # exactly and trace_step merges via that row index
    quad_objs = [(i, o) for i, o in enumerate(objects)
                 if getattr(o, "quad_abgd", None) is not None]
    quad_tri_np = None
    if quad_objs:
        quad_tri_np = np.array(
            [int(np.nonzero(elem_np == i)[0][0]) for i, _ in quad_objs],
            np.int32)
        rows[quad_tri_np] = 0.0

    T_pad = _round_up(max(T, 1), pad_to)
    pad = T_pad - T

    def _p(a, fill=0.0):
        a = np.asarray(a)
        if pad == 0:
            return a
        shape = (pad,) + a.shape[1:]
        return np.concatenate([a, np.full(shape, fill, a.dtype)])

    scene = Scene(
        v0=jnp.asarray(_p(v0), jnp.float32),
        e1=jnp.asarray(_p(e1), jnp.float32),
        e2=jnp.asarray(_p(e2), jnp.float32),
        normal=jnp.asarray(_p(n_unit), jnp.float32),
        wu=jnp.asarray(_p(rows[:, 0]), jnp.float32),
        wv=jnp.asarray(_p(rows[:, 1]), jnp.float32),
        ww=jnp.asarray(_p(rows[:, 2]), jnp.float32),
        mat=jnp.asarray(_p(mat_np, fill=int(Material.TERMINATOR)), jnp.int32),
        ior=jnp.asarray(_p(ior_np, fill=1.0), jnp.float32),
        ior_b=jnp.asarray(_p(iorb_np, fill=0.0), jnp.float32),
        ior_c=jnp.asarray(_p(iorc_np, fill=0.0), jnp.float32),
        absorb=jnp.asarray(_p(absorb_np, fill=0.0), jnp.float32),
        reflectivity=jnp.asarray(_p(refl_np, fill=0.0), jnp.float32),
        detector_id=jnp.asarray(_p(det_np, fill=-1), jnp.int32),
        axis=jnp.asarray(_p(axis_np, fill=0.0), jnp.float32),
        retardance=jnp.asarray(_p(ret_np, fill=0.0), jnp.float32),
        grating_mlp=jnp.asarray(_p(gr_np, fill=0.0), jnp.float32),
        grating_g0=jnp.asarray(_p(g0_np, fill=0.0), jnp.float32),
        metal_n=jnp.asarray(_p(mn_np, fill=0.0), jnp.float32),
        metal_k=jnp.asarray(_p(mk_np, fill=0.0), jnp.float32),
        coat_ior=jnp.asarray(_p(cior_np, fill=0.0), jnp.float32),
        coat_thickness=jnp.asarray(_p(cth_np, fill=0.0), jnp.float32),
        bire_ne=jnp.asarray(_p(bire_np, fill=0.0), jnp.float32),
        scat_mu=jnp.asarray(_p(smu_np, fill=0.0), jnp.float32),
        scat_g=jnp.asarray(_p(sg_np, fill=0.0), jnp.float32),
        rough_sigma=jnp.asarray(_p(rsig_np, fill=0.0), jnp.float32),
        rough_g=jnp.asarray(_p(rg_np, fill=0.0), jnp.float32),
        element_id=jnp.asarray(_p(elem_np, fill=-1), jnp.int32),
    )
    if quad_objs:
        scene = scene._replace(
            quad_abgd=jnp.asarray(
                np.stack([o.quad_abgd for _, o in quad_objs]), jnp.float32),
            quad_rlim=jnp.asarray(
                np.stack([o.quad_rlim for _, o in quad_objs]), jnp.float32),
            quad_zlim=jnp.asarray(
                np.stack([o.quad_zlim for _, o in quad_objs]), jnp.float32),
            quad_vertex=jnp.asarray(
                np.stack([o.quad_vertex for _, o in quad_objs]),
                jnp.float32),
            quad_frame=jnp.asarray(
                np.stack([o.quad_frame for _, o in quad_objs]), jnp.float32),
            quad_tri=jnp.asarray(quad_tri_np),
        )
    # per-element fluorescence tables (indexed by rays.medium, NOT by
    # triangle — spatial_sort does not touch them). Only attached when
    # some element fluoresces, so clear scenes keep fluor_* = None
    if any(float(getattr(o, "fluorescence", 0.0)) > 0.0 for o in objects):
        E = len(objects)
        knot_rows = [o.emission_knots() if getattr(o, "fluorescence", 0.0) > 0
                     else np.zeros((0,)) for o in objects]
        K = max(len(r) for r in knot_rows)
        icdf = np.zeros((E, K), np.float64)
        for i, r in enumerate(knot_rows):
            if len(r):
                icdf[i] = np.interp(np.linspace(0, 1, K),
                                    np.linspace(0, 1, len(r)), r)
        scene = scene._replace(
            fluor_mu=jnp.asarray(
                [float(getattr(o, "fluorescence", 0.0)) for o in objects],
                jnp.float32),
            fluor_qy=jnp.asarray(
                [float(getattr(o, "fluor_yield", 1.0)) for o in objects],
                jnp.float32),
            fluor_edge=jnp.asarray(
                [o.fluor_edge_um() if hasattr(o, "fluor_edge_um") else 0.0
                 for o in objects], jnp.float32),
            fluor_icdf=jnp.asarray(icdf, jnp.float32),
        )
    if any(float(getattr(o, "grin_a", 0.0)) != 0.0 for o in objects):
        E = len(objects)
        ga = np.zeros((E,)); gn = np.ones((E,))
        gc = np.zeros((E, 3)); gx = np.tile([0.0, 0.0, 1.0], (E, 1))
        for i, o in enumerate(objects):
            if float(getattr(o, "grin_a", 0.0)) != 0.0:
                ga[i] = float(o.grin_a)
                gn[i] = float(o.ior)
                gc[i] = np.asarray(o.grin_center, np.float64)
                gx[i] = np.asarray(o.axis, np.float64)
        # compact surface set for grin_substeps: gather the grin elements'
        # triangle transform rows (element_id rides any spatial sort, and
        # padding rows carry element_id = -1 so they never join)
        eid = np.asarray(scene.element_id)
        is_grin_tri = np.zeros(eid.shape, bool)
        for i, o in enumerate(objects):
            if float(getattr(o, "grin_a", 0.0)) != 0.0:
                is_grin_tri |= eid == i
        gwu = np.asarray(scene.wu)[is_grin_tri]
        gwv = np.asarray(scene.wv)[is_grin_tri]
        gww = np.asarray(scene.ww)[is_grin_tri]
        pad_g = _round_up(max(len(gwu), 1), 128) - len(gwu)
        if pad_g:
            z = np.zeros((pad_g, 4), gwu.dtype)  # zero rows never hit
            gwu, gwv, gww = (np.concatenate([a, z])
                             for a in (gwu, gwv, gww))
        scene = scene._replace(
            grin_a=jnp.asarray(ga, jnp.float32),
            grin_n0=jnp.asarray(gn, jnp.float32),
            grin_center=jnp.asarray(gc, jnp.float32),
            grin_axis=jnp.asarray(gx, jnp.float32),
            grin_wu=jnp.asarray(gwu, jnp.float32),
            grin_wv=jnp.asarray(gwv, jnp.float32),
            grin_ww=jnp.asarray(gww, jnp.float32),
        )
    return scene, detector_names
