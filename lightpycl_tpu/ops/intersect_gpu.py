"""Pallas kernel (Triton route): ray x triangle nearest hit, the hot loop.

Reference equivalent: the `intersect` OpenCL kernel — one work-item per
ray, a serial Möller–Trumbore loop over every triangle keeping the minimum
t and its argmin in private memory (SURVEY.md §3 'Intersect kernel'). This
kernel lands close to that design, with the triangle loop tiled:

* A 1-D grid over blocks of R rays. Each program keeps its ray block and
  the running nearest hit in registers and streams the whole triangle set
  through a `fori_loop` over tiles of K triangles. Nothing carries over
  between programs.
* Each triangle carries a precomputed world->unit affine transform (rows
  wu/wv/ww, built in tracer/scene.py), packed by `pack_w4` into a
  (4, n_tiles * 3K) stream: [u-cols | v-cols | w-cols] per tile. For every
  (ray, triangle) pair the plane coordinates are broadcast FMAs in true
  fp32 — the K=4 contraction is far too skinny for the tensor cores, and
  TF32 would corrupt the ill-conditioned transforms of skinny triangles:

      OU = o . wu + wu_b   DU = d . wu      (likewise V, W)
      q = OW / DW  (= -t);  u = OU - q DU;  v = OV - q DV
      hit = (q < -eps) & (min(u, v) >= -eps_b) & (u + v <= 1 + eps_b)

  IEEE semantics stand in for guards: DW == 0 gives q = +-inf or NaN
  (all-zero padding rows), and every comparison then fails -> no hit.
* Running maximum of q (nearest hit = largest q = -t) per (ray, lane):
  every lane keeps its own best q and the tile it came from, so a tile
  costs two selects per pair and no cross-thread reduction. One reduction
  over the K lanes after the loop picks the smallest triangle index among
  the ties — the same first-argmin rule as `step.intersect_jnp`.
* The `t < t_max` window is applied to the single winner after the loop
  (equivalent by monotonicity of the minimum).
* Cull (cfg.cull): a conservative (ray block x cull tile) reachability
  mask, bitpacked into (n_rb, n_words) int32 words in HBM. A program reads
  its own row and skips a cull tile's loads and compute (`lax.cond`) when
  its bit is 0. The mask only skips pairs that provably cannot hit, so
  results equal the brute-force ones.

The reflect/refract stage (reference kernel #2) stays in XLA: it is O(C)
elementwise work that XLA fuses on its own.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from lightpycl_tpu.tracer.config import TraceConfig
from lightpycl_tpu.tracer.scene import Scene

# Launch shape, from sweeps on an H100 SXM at the config-4 shape, 4M rays
# x 137,472 triangles (benchmarks/intersect_bench.py; CHANGES.md). Brute
# force, 700 W card: R=64/K=16 1.097 s, R=32/K=32 1.114 s, R=64/K=32
# 1.185 s, R=128/K=32 3.25 s; num_stages 1-3 within 1%. The cull tile is
# the mask's granularity; on Morton-sorted first-bounce rays, 400 W card:
# 64 triangles 0.035 s, 128 0.036 s, 256 0.050 s, 1024 0.122 s.
RAY_BLOCK = 64       # R: rays per program (power of two)
TRI_TILE = 16        # K: triangles per loop step (power of two)
CULL_TILE = 128      # triangles per cull-mask bit (a multiple of TRI_TILE)
NUM_WARPS = 4
NUM_STAGES = 2

_INF = float(np.inf)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _kernel(*refs, K, n_sub, n_groups, cull, eps, eps_b):
    """One program: R rays against the whole triangle stream.

    refs: [mask (n_rb, n_words) i32,] o (R, 3), d (R, 3), w (4, n*3K),
    q (R,) best q = -t, i (R,) best triangle index."""
    if cull:
        mask_ref, o_ref, d_ref, w_ref, q_ref, i_ref = refs
    else:
        o_ref, d_ref, w_ref, q_ref, i_ref = refs
    R = q_ref.shape[0]
    ox, oy, oz = (o_ref[:, k][:, None] for k in range(3))   # (R, 1)
    dx, dy, dz = (d_ref[:, k][:, None] for k in range(3))

    def tile(j, carry):
        best_q, best_j = carry                               # (R, K)
        base = j * (3 * K)

        def transform(p):
            rx, ry, rz, rb = (w_ref[r, pl.ds(base + p * K, K)][None, :]
                              for r in range(4))
            return ox * rx + oy * ry + oz * rz + rb, dx * rx + dy * ry + dz * rz

        OU, DU = transform(0)
        OV, DV = transform(1)
        OW, DW = transform(2)
        q = OW / DW
        u = OU - q * DU
        v = OV - q * DV
        hit = (q < -eps) & (jnp.minimum(u, v) >= -eps_b) & (u + v <= 1.0 + eps_b)
        qq = jnp.where(hit, q, -_INF)
        better = qq > best_q              # strict: a lane keeps its first tile
        return jnp.where(better, qq, best_q), jnp.where(better, j, best_j)

    carry = (jnp.full((R, K), -_INF, jnp.float32),
             jnp.zeros((R, K), jnp.int32))
    if cull:
        row = pl.program_id(0)

        def group(g, carry):
            # g >= 0: shifts and masks instead of // and %
            word = mask_ref[row, jax.lax.shift_right_logical(g, 5)]
            bit = jax.lax.shift_right_logical(word, g & 31) & 1
            return jax.lax.cond(
                bit != 0,
                lambda c: jax.lax.fori_loop(
                    0, n_sub, lambda s, cc: tile(g * n_sub + s, cc), c),
                lambda c: c,
                carry)

        best_q, best_j = jax.lax.fori_loop(0, n_groups, group, carry)
    else:
        best_q, best_j = jax.lax.fori_loop(0, n_groups * n_sub, tile, carry)

    q_max = jnp.max(best_q, axis=1)                          # (R,)
    lane = jax.lax.broadcasted_iota(jnp.int32, (R, K), 1)
    idx = jnp.where(best_q == q_max[:, None], best_j * K + lane,
                    jnp.int32(2**30))
    q_ref[...] = q_max
    i_ref[...] = jnp.min(idx, axis=1)


def _cull_mask(o, d, aabb_lo, aabb_hi, R, t_max, alive=None):
    """(n_rb, n_tt) int32 conservative reachability of tri-tile AABBs from
    ray blocks. Never false-culls: any uncertainty -> 1. Three independent
    necessary-condition tests are ANDed (each pass-set contains the truly
    reachable set, so their intersection still does):

      1. per-axis interval arithmetic on the block's origin box and
         direction box (strong for axis-aligned collimated bundles);
      2. a direction-cone vs bounding-sphere angular test: the block's live
         rays fit in a cone (mean direction m, half-angle from min d.m);
         the tile fits in a sphere; cull when the cone cannot point at it
         (strong for diverging/reflected bundles);
      3. blocks with no live rays cull everything (their results are
         masked out downstream anyway).
    """
    n_rb = o.shape[0] // R
    o_b = o.reshape(n_rb, R, 3)
    d_b = d.reshape(n_rb, R, 3)
    if alive is None:
        alive_b = jnp.ones((n_rb, R), bool)
    else:
        pad = o.shape[0] - alive.shape[0]
        if pad:
            alive = jnp.concatenate([alive, jnp.zeros((pad,), bool)])
        alive_b = alive.reshape(n_rb, R)
    any_alive = alive_b.any(axis=1)                   # (n_rb,)

    o_lo, o_hi = o_b.min(axis=1), o_b.max(axis=1)     # (n_rb, 3)
    d_lo, d_hi = d_b.min(axis=1), d_b.max(axis=1)
    BIG = jnp.float32(3.4e38)
    tiny = 1e-12
    pos = d_lo > tiny
    neg = d_hi < -tiny
    par = (jnp.abs(d_lo) <= tiny) & (jnp.abs(d_hi) <= tiny)
    reach_lo = jnp.where(pos | par, o_lo, -BIG)       # (n_rb, 3)
    reach_hi = jnp.where(neg | par, o_hi, BIG)
    # t_max caps the reach (origins +- t_max along unit directions)
    reach_lo = jnp.maximum(reach_lo, o_lo - jnp.float32(t_max))
    reach_hi = jnp.minimum(reach_hi, o_hi + jnp.float32(t_max))
    miss_axis = (
        (aabb_lo[None, :, :] > reach_hi[:, None, :])
        | (aabb_hi[None, :, :] < reach_lo[:, None, :])
    ).any(axis=2)                                     # (n_rb, n_tt)

    # --- cone test (live rays only; dead rays would blow up the cone) ---
    af = alive_b.astype(jnp.float32)[:, :, None]
    m = jnp.sum(d_b * af, axis=1)
    m_len = jnp.linalg.norm(m, axis=1, keepdims=True)
    m = m / jnp.maximum(m_len, 1e-20)                 # (n_rb, 3) mean dir
    cosm = jnp.sum(d_b * m[:, None, :], axis=2)       # (n_rb, R)
    cos_bundle = jnp.min(jnp.where(alive_b, cosm, 1.0), axis=1)
    cos_bundle = jnp.clip(cos_bundle, -1.0, 1.0)      # (n_rb,)
    sin_bundle = jnp.sqrt(1.0 - cos_bundle**2)
    # degenerate bundle (opposing directions): cone covers everything
    full_cone = (cos_bundle <= 0.0) | (m_len[:, 0] < 1e-12)

    o_c = 0.5 * (o_lo + o_hi)                         # (n_rb, 3)
    o_r = 0.5 * jnp.linalg.norm(o_hi - o_lo, axis=1)  # (n_rb,)
    t_c = 0.5 * (aabb_lo + aabb_hi)                   # (n_tt, 3)
    t_r = 0.5 * jnp.linalg.norm(aabb_hi - aabb_lo, axis=1)
    v = t_c[None, :, :] - o_c[:, None, :]             # (n_rb, n_tt, 3)
    dist = jnp.linalg.norm(v, axis=2)                 # (n_rb, n_tt)
    rad = t_r[None, :] + o_r[:, None]
    overlap = dist <= rad                             # inside -> pass
    s_beta = jnp.clip(rad / jnp.maximum(dist, 1e-20), 0.0, 1.0)
    c_beta = jnp.sqrt(1.0 - s_beta**2)
    cos_needed = (cos_bundle[:, None] * c_beta
                  - sin_bundle[:, None] * s_beta)     # cos(bundle + beta)
    cos_actual = jnp.sum(v * m[:, None, :], axis=2) / jnp.maximum(dist, 1e-20)
    miss_cone = (~overlap) & (cos_actual < cos_needed) & ~full_cone[:, None]
    # t_max cap on the cone test too
    miss_cone = miss_cone | ((dist - rad) > jnp.float32(t_max))

    reach = ~(miss_axis | miss_cone) & any_alive[:, None]
    return reach.astype(jnp.int32)


def pack_mask(reach):
    """Bitpack an (n_rb, n_tt) 0/1 mask into (n_rb, ceil(n_tt/32)) int32
    words: bit g % 32 of word g // 32 is tile g."""
    n_rb, n_tt = reach.shape
    n_words = -(-n_tt // 32)
    m = jnp.pad(reach, ((0, 0), (0, n_words * 32 - n_tt)))
    weights = jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32)
    words = jnp.sum(m.reshape(n_rb, n_words, 32).astype(jnp.uint32) * weights,
                    axis=2, dtype=jnp.uint32)
    return jax.lax.bitcast_convert_type(words, jnp.int32)


def pack_aabbs(scene: Scene, tri_tile: int):
    """Per-tile AABBs (n_tt, 3) lo/hi for the cull mask. Degenerate/padding
    triangles (all-zero plane row) contribute an empty box."""
    Tp = scene.wu.shape[0]
    K = tri_tile
    Tt = _round_up(Tp, K)
    BIG = jnp.float32(3.4e38)
    valid = jnp.any(scene.ww != 0.0, axis=1)[:, None]          # (Tp, 1)
    v0, e1, e2 = scene.v0, scene.e1, scene.e2
    tri_lo = jnp.minimum(v0, jnp.minimum(v0 + e1, v0 + e2))
    tri_hi = jnp.maximum(v0, jnp.maximum(v0 + e1, v0 + e2))
    tri_lo = jnp.where(valid, tri_lo, BIG)
    tri_hi = jnp.where(valid, tri_hi, -BIG)

    def _tile(a, fill):
        if Tt != Tp:
            a = jnp.concatenate(
                [a, jnp.full((Tt - Tp, 3), fill, jnp.float32)])
        return a.reshape(Tt // K, K, 3)

    lo = _tile(tri_lo, 3.4e38).min(axis=1)
    hi = _tile(tri_hi, -3.4e38).max(axis=1)
    return lo, hi


def pack_w4(scene: Scene, tri_tile: int, n_tris: int | None = None):
    """Pack per-triangle transform rows into the kernel's streaming layout:
    (4, n_tiles * 3K), each tile holding [u-cols | v-cols | w-cols], for
    `n_tris` triangles (default: the scene's padded count rounded up to K).
    Padding triangles have all-zero rows -> DW == 0 -> never hit."""
    Tp = scene.wu.shape[0]
    K = tri_tile
    Tt = n_tris or _round_up(Tp, K)

    def _prep(a):
        a = a.T  # (4, Tp)
        if Tt != Tp:
            a = jnp.pad(a, ((0, 0), (0, Tt - Tp)))
        return a.reshape(4, Tt // K, K)

    stacked = jnp.stack([_prep(scene.wu), _prep(scene.wv), _prep(scene.ww)],
                        axis=2)
    return stacked.reshape(4, (Tt // K) * 3 * K)


@functools.partial(
    jax.jit,
    static_argnames=("eps", "eps_b", "t_max", "ray_block", "tri_tile",
                     "n_sub", "cull", "num_warps", "num_stages", "interpret"),
)
def _intersect_impl(o, d, w4, aabb_lo, aabb_hi, alive, *, eps, eps_b, t_max,
                    ray_block, tri_tile, n_sub, cull, num_warps, num_stages,
                    interpret):
    C = o.shape[0]
    R, K = ray_block, tri_tile
    Cp = _round_up(C, R)
    if Cp != C:
        o = jnp.pad(o, ((0, Cp - C), (0, 0)))
        d = jnp.pad(d, ((0, Cp - C), (0, 0)), constant_values=1.0)
    n_rb = Cp // R
    n_groups = w4.shape[1] // (3 * K * n_sub)

    ray_spec = pl.BlockSpec((R, 3), lambda i: (i, 0))
    in_specs = [ray_spec, ray_spec, pl.no_block_spec]
    args = [o, d, w4]
    if cull:
        mask = pack_mask(_cull_mask(o, d, aabb_lo, aabb_hi, R, t_max,
                                    alive=alive))
        in_specs.insert(0, pl.no_block_spec)
        args.insert(0, mask)

    kernel = functools.partial(_kernel, K=K, n_sub=n_sub, n_groups=n_groups,
                               cull=cull, eps=eps, eps_b=eps_b)
    out_spec = pl.BlockSpec((R,), lambda i: (i,))
    q, i = pl.pallas_call(
        kernel,
        grid=(n_rb,),
        in_specs=in_specs,
        out_specs=(out_spec, out_spec),
        out_shape=(jax.ShapeDtypeStruct((Cp,), jnp.float32),
                   jax.ShapeDtypeStruct((Cp,), jnp.int32)),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        backend="triton",
        interpret=interpret,
        name="intersect_nearest_hit",
    )(*args)
    t = -q[:C]  # the kernel keeps q = -t; IEEE negation is exact
    valid = jnp.isfinite(t) & (t < t_max)
    return jnp.where(valid, t, _INF), jnp.where(valid, i[:C], -1)


def intersect_gpu(scene: Scene, o, d, cfg: TraceConfig, alive=None,
                  cull: bool | None = None, *, interpret: bool = False,
                  ray_block: int | None = None, tri_tile: int | None = None,
                  cull_tile: int | None = None, num_warps: int | None = None,
                  num_stages: int | None = None):
    """Nearest hit over the scene: (t (C,), tri (C,) i32; tri == -1 and
    t == +inf on a miss). Drop-in for step.intersect_jnp.

    cull (default cfg.cull) turns on the conservative ray-block x
    cull-tile reachability mask; `alive` (C,) lets it skip all-dead ray
    blocks. `interpret=True` runs the kernel in the Pallas interpreter
    (CPU tests only). The launch shape defaults to the module constants."""
    if cull is None:
        cull = bool(cfg.cull)
    K = int(tri_tile or TRI_TILE)
    Tk = _round_up(scene.num_triangles_padded, K)
    # small scenes: one cull tile never spans more than the scene itself
    n_sub = max(1, min(int(cull_tile or CULL_TILE), Tk) // K) if cull else 1
    n_tris = _round_up(Tk, K * n_sub)
    w4 = pack_w4(scene, K, n_tris)
    if cull:
        aabb_lo, aabb_hi = pack_aabbs(scene, K * n_sub)
        if alive is None:
            alive = jnp.ones((o.shape[0],), bool)
    else:
        aabb_lo = aabb_hi = alive = None
    return _intersect_impl(
        o, d, w4, aabb_lo, aabb_hi, alive, eps=float(cfg.eps),
        eps_b=float(cfg.eps_bary), t_max=float(cfg.max_ray_len),
        ray_block=int(ray_block or RAY_BLOCK), tri_tile=K, n_sub=n_sub,
        cull=bool(cull), num_warps=int(num_warps or NUM_WARPS),
        num_stages=int(num_stages or NUM_STAGES), interpret=bool(interpret))
