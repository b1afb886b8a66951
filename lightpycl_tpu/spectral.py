"""Wavelength-parallel tracing: W spectral samples share one geometry pass.

In the scalar engine each ray carries ONE wavelength; resolving a spectral
response (e.g. a coating's R(lambda) curve) takes W independent traces,
re-paying the ray x triangle intersection cost — the dominant cost — W
times. When the scene's GEOMETRY is achromatic (no dispersive glass, no
gratings: directions don't depend on wavelength), only the POWER bookkeeping
is spectral: Fresnel splits at coated surfaces weight each wavelength
differently. This module traces a (C, W) power matrix through a single
geometry pass: intersection and Snell directions are computed once per
bounce, the thin-film reflectance is evaluated per wavelength column, and
the power ledger is kept per wavelength — conservation holds COLUMN-WISE,
so every spectral sample is individually audited.

Speedup ~= W x on intersect-bound scenes (the usual case): the wavelength
axis is a vectorized axis of the shade epilogue, not a loop.

Supported materials: mirror, refractive (bare or coated), terminator,
measure, beamsplitter. Rejected (they make geometry or polarization state
wavelength- or RNG-dependent): dispersive glass (ior_b != 0), gratings,
polarizer/waveplate (the scalar model here is unpolarized), diffuse.
No reference equivalent (the reference is monochromatic per run).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from lightpycl_tpu import physics
from lightpycl_tpu.materials import Material
from lightpycl_tpu.tracer.config import TraceConfig
from lightpycl_tpu.tracer.rays import DetectorState, RayBatch
from lightpycl_tpu.tracer.scene import Scene
from lightpycl_tpu.tracer.step import (
    accumulate_detector_arrays, gather_hit_attrs, intersect,
    merge_analytic,
)


class SpectralRays(NamedTuple):
    """Ray geometry shared across wavelengths; power per (ray, wavelength)."""

    o: jnp.ndarray        # (C, 3) f32
    d: jnp.ndarray        # (C, 3) f32 unit directions
    P: jnp.ndarray        # (C, W) f32 power per spectral sample
    ior: jnp.ndarray      # (C,) f32 current-medium IOR (achromatic)
    absorb: jnp.ndarray   # (C,) f32 current-medium absorption [1/len]
    alive: jnp.ndarray    # (C,) bool
    opl: jnp.ndarray      # (C,) f32 accumulated optical path length
    #   (shared across columns — achromatic geometry means every spectral
    #   sample rides the same path; feeds the ToF time_hist)

    @property
    def capacity(self) -> int:
        return self.o.shape[0]

    @staticmethod
    def from_batch(rays: RayBatch, weights) -> "SpectralRays":
        """Spread a RayBatch over W spectral samples: each ray's power is
        distributed as power * weights (weights (W,), summing to 1 for a
        straight split)."""
        w = jnp.asarray(weights, jnp.float32)
        return SpectralRays(
            o=rays.o, d=rays.d,
            P=rays.power[:, None] * w[None, :],
            ior=rays.ior, absorb=rays.absorb, alive=rays.alive,
            opl=rays.opl,
        )


class SpectralLedger(NamedTuple):
    """Per-wavelength power ledger (each field (W,)): emitted ==
    measured + absorbed + escaped + culled + live, per column."""

    emitted: jnp.ndarray
    measured: jnp.ndarray
    absorbed: jnp.ndarray
    escaped: jnp.ndarray
    culled: jnp.ndarray

    def accounted(self):
        return self.measured + self.absorbed + self.escaped + self.culled


def validate_spectral_scene(elements) -> None:
    """Reject scenes whose geometry or physics is wavelength-coupled in a
    way the shared-geometry model cannot represent."""
    for el in elements:
        if (float(getattr(el, "dispersion_b", 0.0)) != 0.0
                or float(getattr(el, "dispersion_c", 0.0)) != 0.0):
            raise ValueError(
                f"spectral tracing needs achromatic geometry; element "
                f"{el.name or el.material} has dispersion_b/_c != 0 "
                "(refraction angles would differ per wavelength — use "
                "per-wavelength scalar traces for dispersive systems)")
        if el.material in (Material.GRATING, Material.POLARIZER,
                           Material.WAVEPLATE, Material.DIFFUSE,
                           Material.BIREFRINGENT):
            raise ValueError(
                f"spectral tracing does not support material "
                f"{Material(el.material).name} (wavelength-dependent "
                "directions / polarization / RNG)")
        if float(getattr(el, "scattering", 0.0)) > 0.0:
            raise ValueError(
                f"shared-geometry spectral tracing cannot draw per-ray "
                f"scatter paths; element {el.name or el.material} has "
                "scattering > 0 (use method='batched' — the dispersive "
                "wavelength-batched path supports turbid media)")
        if float(getattr(el, "grin_a", 0.0)) != 0.0:
            raise ValueError(
                f"shared-geometry spectral tracing cannot advance curved "
                f"GRIN steps; element {el.name or el.material} has a "
                "gradient profile (use method='batched')")
        if float(getattr(el, "fluorescence", 0.0)) > 0.0:
            raise ValueError(
                f"spectral tracing assumes wavelengths are conserved, but "
                f"element {el.name or el.material} fluoresces (conversion "
                "changes the carried wavelength mid-trace, so per-lambda "
                "ledger columns cannot close). Trace scalar: the measured-"
                "ray harvest carries per-ray wavelengths, and "
                "analysis.spectral_power / cie_xyz bin the output spectrum")


def spectral_step(scene: Scene, sr: SpectralRays, det: DetectorState,
                  per_det, led: SpectralLedger,
                  wavelengths, cfg: TraceConfig):
    """One bounce of the wavelength-parallel trace. Geometry identical to
    tracer/step.py's shade (same physics helpers); power is (C, W).
    `det` (angular histogram / per-detector totals / planar image)
    accumulates the ROW-TOTAL measured power through the same binning code
    as the scalar engine (accumulate_detector_arrays); `per_det` keeps the
    full (D, W) per-detector spectra."""
    C, W = sr.P.shape
    t, tri = intersect(scene, sr.o, sr.d, cfg, alive=sr.alive)
    # exact quadric surfaces merge here too (ADVICE r3: they used to be
    # silently invisible to spectral traces); valid for the shared-
    # geometry model since analytic surfaces are deterministic and
    # achromatic (dispersion is refused scene-wide above)
    t, tri, quad_hit = merge_analytic(scene, sr.o, sr.d, t, tri, cfg)
    hit_valid = (tri >= 0) & sr.alive
    safe_tri = jnp.maximum(tri, 0)

    t_draw = jnp.where(hit_valid, t, cfg.max_ray_len)
    hit_point = sr.o + t_draw[:, None] * sr.d

    live_P = jnp.where(sr.alive[:, None], sr.P, 0.0)
    atten = jnp.exp(-sr.absorb * t_draw)[:, None]
    bulk_absorbed = jnp.sum(live_P * (1.0 - atten), axis=0)
    live_P = live_P * atten

    attrs = gather_hit_attrs(scene, safe_tri, with_optics=False,
                             with_coatings=cfg.has_coatings)
    if quad_hit is not None:
        # exact quadric gradient replaces the placeholder facet normal
        use_q, nq = quad_hit
        attrs["normal"] = jnp.where(use_q[:, None], nq, attrs["normal"])
    mat = attrs["mat"]
    refl = attrs["reflectivity"]
    sn = physics.snell_interaction(sr.d, attrs["normal"], sr.ior,
                                   attrs["ior"], cfg.ior_env)
    if cfg.has_metals:
        # metal mirrors: n, k are wavelength-constant per element here, so
        # R(theta) is shared across the spectral columns
        refl = jnp.where(attrs["metal_n"] > 0.0,
                         refl * physics.metal_reflectance(
                             sn["cos_i"], sn["n1"], attrs["metal_n"],
                             attrs["metal_k"]),
                         refl)

    R = jnp.broadcast_to(sn["R"][:, None], (C, W))
    if cfg.has_coatings:
        cn, ch = attrs["coat_ior"], attrs["coat_thickness"]   # (C, L)
        ent = sn["entering"][:, None]
        cn = jnp.where(ent, cn, cn[:, ::-1])
        ch = jnp.where(ent, ch, ch[:, ::-1])
        wl_row = jnp.asarray(wavelengths, jnp.float32)[None, :]  # (1, W)
        L = cn.shape[1]
        # per-ray layer stacks broadcast against the wavelength row:
        # every input (C, 1) x (1, W) -> (C, W) reflectance surface
        R_film = physics.multilayer_reflectance(
            sn["cos_i"][:, None], sn["n1"][:, None],
            [cn[:, l][:, None] for l in range(L)],
            [ch[:, l][:, None] for l in range(L)],
            sn["n2"][:, None], wl_row)
        R_film = jnp.where(sn["tir"][:, None], 1.0, R_film)
        R = jnp.where(jnp.max(ch, axis=1)[:, None] > 0.0, R_film, R)

    is_mirror = hit_valid & (mat == int(Material.MIRROR))
    is_refr = hit_valid & (mat == int(Material.REFRACTIVE))
    is_term = hit_valid & (mat == int(Material.TERMINATOR))
    is_meas = hit_valid & (mat == int(Material.MEASURE))
    is_bs = hit_valid & (mat == int(Material.BEAMSPLITTER))
    is_miss = sr.alive & ~hit_valid
    refl_like = is_mirror | is_bs

    pa = jnp.where(refl_like[:, None], live_P * refl[:, None],
                   jnp.where(is_refr[:, None], live_P * R, 0.0))
    pb = jnp.where(is_refr[:, None], live_P * (1.0 - R),
                   jnp.where(is_bs[:, None], live_P * (1.0 - refl[:, None]),
                             0.0))
    da = sn["refl_dir"]
    db = jnp.where(is_bs[:, None], sr.d, sn["refr_dir"])
    b_ior = jnp.where(is_bs, sr.ior, sn["new_ior"])
    refr_absorb = jnp.where(is_bs, sr.absorb,
                            jnp.where(sn["entering"], attrs["absorb"], 0.0))

    measured_P = jnp.where(is_meas[:, None], live_P, 0.0)
    did = jnp.clip(attrs["detector_id"], 0, per_det.shape[0] - 1)
    per_det = per_det.at[did].add(measured_P)
    # OPL shared across columns (achromatic geometry); row-total power
    # feeds the wavelength-integrated surfaces (ToF histogram, flux map)
    # exactly as the scalar step does
    opl_new = sr.opl + sr.ior * t_draw
    inc = (jnp.where(hit_valid, jnp.sum(live_P, axis=1), 0.0)
           if cfg.flux_map else None)
    det = accumulate_detector_arrays(
        det, hit_point, sr.d, jnp.sum(measured_P, axis=1),
        attrs["detector_id"], cfg, opl=opl_new,
        tri=tri if cfg.flux_map else None, incident_power=inc)

    absorbed = (bulk_absorbed
                + jnp.sum(jnp.where(is_term[:, None], live_P, 0.0), axis=0)
                + jnp.sum(jnp.where(is_mirror[:, None],
                                    live_P * (1.0 - refl[:, None]), 0.0),
                          axis=0))
    escaped = jnp.sum(jnp.where(is_miss[:, None], live_P, 0.0), axis=0)

    # children at slots (i, C+i), compacted back to C by total-row power.
    # Same scale-proportional relaunch push as the scalar shade
    # (step._relaunch_push): off the parent facet along the outgoing
    # direction, its length folded into the child OPL below
    push = (1e-6 * (jnp.linalg.norm(sr.o, axis=1) + t_draw))[:, None]
    child_o = jnp.concatenate([hit_point + push * da,
                               hit_point + push * db])
    child_d = jnp.concatenate([da, db])
    child_P = jnp.concatenate([pa, pb])
    child_ior = jnp.concatenate([sr.ior, b_ior])
    child_ab = jnp.concatenate([sr.absorb, refr_absorb])
    row = jnp.sum(child_P, axis=1)
    child_live = row > cfg.power_cutoff
    key = jnp.where(child_live, row, -1.0)
    _, idx = jax.lax.top_k(key, C)
    sel_live = child_live[idx]
    sel_P = jnp.where(sel_live[:, None], child_P[idx], 0.0)
    # per-wavelength culled power: whatever of the 2C children's columns
    # did not survive selection (cutoff rows + topk overflow; zero rows
    # contribute nothing)
    culled_cols = jnp.sum(child_P, axis=0) - jnp.sum(sel_P, axis=0)

    child_opl = jnp.concatenate([opl_new + push[:, 0] * sr.ior,
                                 opl_new + push[:, 0] * b_ior])
    new_sr = SpectralRays(
        o=child_o[idx], d=child_d[idx], P=sel_P,
        ior=child_ior[idx], absorb=child_ab[idx], alive=sel_live,
        opl=child_opl[idx],
    )
    led = SpectralLedger(
        emitted=led.emitted,
        measured=led.measured + jnp.sum(measured_P, axis=0),
        absorbed=led.absorbed + absorbed,
        escaped=led.escaped + escaped,
        culled=led.culled + culled_cols,
    )
    return new_sr, det, per_det, led


@functools.partial(jax.jit, static_argnames=("cfg", "iterations", "n_detectors"))
def trace_spectral_jit(scene: Scene, sr: SpectralRays, wavelengths,
                       cfg: TraceConfig, iterations: int, n_detectors: int):
    W = sr.P.shape[1]
    det = DetectorState.zeros(cfg.hist_azimuth_bins, cfg.hist_polar_bins,
                              n_detectors, cfg.image_bins,
                              n_tris=(scene.mat.shape[0] if cfg.flux_map
                                      else 0),
                              time_bins=cfg.time_bins)
    per_det = jnp.zeros((max(n_detectors, 1), W), jnp.float32)
    z = jnp.zeros((W,), jnp.float32)
    led = SpectralLedger(
        emitted=jnp.sum(jnp.where(sr.alive[:, None], sr.P, 0.0), axis=0),
        measured=z, absorbed=z, escaped=z, culled=z,
    )

    def body(_, state):
        sr, det, per_det, led = state
        return spectral_step(scene, sr, det, per_det, led, wavelengths, cfg)

    sr, det, per_det, led = jax.lax.fori_loop(
        0, iterations, body, (sr, det, per_det, led))
    return sr, det, per_det, led


def spread_rays_over_wavelengths(rays: RayBatch, wavelengths,
                                 weights) -> RayBatch:
    """Flatten the wavelength axis into the ray axis: a (W * C)-capacity
    batch where lane k (slots [k*C, (k+1)*C)) is a wavelength-stamped copy
    of `rays` carrying weights[k] of each ray's power. This is the
    DISPERSIVE counterpart of SpectralRays.from_batch: every ray carries
    its own wavelength, so refraction angles (Cauchy glass) and grating
    orders resolve per wavelength at the cost of W geometry passes' worth
    of intersection work — batched into ONE trace."""
    wl = jnp.asarray(wavelengths, jnp.float32)
    w = jnp.asarray(weights, jnp.float32)
    W = wl.shape[0]
    C = rays.capacity

    def tile(x):
        return jnp.concatenate([x] * W, axis=0)

    return rays._replace(
        o=tile(rays.o), d=tile(rays.d),
        power=tile(rays.power) * jnp.repeat(w, C),
        ior=tile(rays.ior), alive=tile(rays.alive),
        wavelength=jnp.repeat(wl, C),
        absorb=tile(rays.absorb),
        s1=tile(rays.s1), s2=tile(rays.s2), s3=tile(rays.s3),
        basis=tile(rays.basis), opl=tile(rays.opl),
        path=tile(rays.path),
        scat=tile(rays.scat), scat_g=tile(rays.scat_g),
        medium=tile(rays.medium),
    )


def _dispersive_loop(scene: Scene, rays: RayBatch, wl_grid,
                     cfg: TraceConfig, iterations: int, n_detectors: int,
                     base_key):
    """Fixed-depth scalar trace of a wavelength-flattened batch with an
    extra (D, W) per-(detector, wavelength) accumulator. Reuses the full
    scalar physics (dispersion, gratings, metals, coatings, polarization);
    the wavelength bin of each measured ray is recovered from its carried
    wavelength (nearest grid point — exact, since children copy the parent
    wavelength verbatim).

    The loop mirrors step.trace_step but accumulates the spectra directly
    from the shade outputs instead of going through trace_step's
    measured-ray harvest aux: the front-compaction epilogue there is a
    13-column cumsum scatter over every slot — dead code XLA prunes in
    device-mode traces, but live (and dominant at W * C slots) if the
    spectra are read from aux. Shared by the single-device jit and the
    per-shard body of the multichip entry point.

    Returns (rays, det, per_dw, led_w) where led_w is a PER-WAVELENGTH
    Ledger — every entry a (W,) column, conserving per column:
    emitted[w] == measured[w] + absorbed[w] + escaped[w] + culled[w] +
    live_final[w]. measured/escaped/dropped bin exactly by the parent's
    carried wavelength (ShadeOut.escaped_power / .dropped_power);
    absorbed[w] is the per-column residual of shade's power flow
    (live_in - measured - escaped - dropped - child_total, which the
    scalar ledger invariant proves equals shade's absorbed to fp
    rounding); culled[w] = child_total[w] - live_after_compaction[w] +
    dropped[w], which attributes roulette kills, below-cutoff drops and
    top-k overflow to the wavelength of the culled child. The scalar
    Ledger is the column sum (see the jit wrappers)."""
    from lightpycl_tpu.tracer import step as step_mod
    from lightpycl_tpu.tracer.rays import Ledger

    D = max(n_detectors, 1)
    W = wl_grid.shape[0]
    det = DetectorState.zeros(cfg.hist_azimuth_bins, cfg.hist_polar_bins,
                              D, cfg.image_bins,
                              n_tris=(scene.mat.shape[0] if cfg.flux_map
                                      else 0),
                              time_bins=cfg.time_bins)
    per_dw = jnp.zeros((D, W), jnp.float32)
    # white-light coherent planes: per-wavelength complex field sums on
    # the image grid (each lambda interferes only with itself; summed
    # per-lambda intensities are the physical white-light pattern with
    # its coherence envelope). Flat nb*nb+1 layout: the last slot absorbs
    # off-grid hits (image_flat_indices contract).
    spectral_coherent = cfg.coherent and cfg.image_bins > 0
    nb = cfg.image_bins
    amp_w = (jnp.zeros((W, 2, nb * nb + 1), jnp.float32)
             if spectral_coherent else jnp.zeros((1,), jnp.float32))
    # the scalar accumulator must NOT also sum a single cross-wavelength
    # plane (different lambdas do not interfere) — its coherent branch is
    # disabled and the per-lambda planes above are the coherent output
    cfg_det = cfg.replace(coherent=False) if spectral_coherent else cfg

    def bin_by(wl, power):
        idx = jnp.argmin(jnp.abs(wl[:, None] - wl_grid[None, :]), axis=1)
        return idx, jnp.zeros((W,), jnp.float32).at[idx].add(power)

    _, emitted_w = bin_by(rays.wavelength,
                          jnp.where(rays.alive, rays.power, 0.0))
    z = jnp.zeros((W,), jnp.float32)
    led_w = Ledger(emitted=emitted_w, measured=z, absorbed=z, escaped=z,
                   culled=z)

    def body(i, st):
        rays, det, per_dw, led_w, amp_w = st
        k = jax.random.fold_in(base_key, i) if cfg.needs_rng else None
        if cfg.cull:
            rays = step_mod.reorder_rays(scene, rays)
        t, tri = step_mod.intersect(scene, rays.o, rays.d, cfg,
                                    alive=rays.alive)
        t, tri, quad_hit = merge_analytic(scene, rays.o, rays.d, t, tri,
                                          cfg)
        attrs = None
        if quad_hit is not None:
            use_q, nq = quad_hit
            attrs = step_mod.default_hit_attrs(scene, jnp.maximum(tri, 0),
                                               cfg)
            attrs["normal"] = jnp.where(use_q[:, None], nq,
                                        attrs["normal"])
        sh = step_mod.shade(scene, rays, t, tri, cfg, attrs=attrs, key=k)
        det = step_mod.accumulate_detector(det, sh, rays, cfg_det, tri=tri)
        # the parent's carried wavelength indexes the spectral column
        wl_idx, live_before_w = bin_by(
            rays.wavelength, jnp.where(rays.alive, rays.power, 0.0))
        did = jnp.clip(sh.det_id, 0, D - 1)
        per_dw = per_dw.at[did, wl_idx].add(sh.measured_power)
        if spectral_coherent:
            C = rays.capacity
            flat = step_mod.image_flat_indices(sh.hit_point, cfg)
            re, im = step_mod.coherent_amplitudes(
                sh.measured_power, sh.child_opl[:C], rays.wavelength)
            amp_w = amp_w.at[wl_idx, 0, flat].add(re)
            amp_w = amp_w.at[wl_idx, 1, flat].add(im)
        m_w = z.at[wl_idx].add(sh.measured_power)
        e_w = z.at[wl_idx].add(sh.escaped_power)
        d_w = z.at[wl_idx].add(sh.dropped_power)
        # children binned BEFORE roulette/compaction so the per-lambda
        # cull column captures everything dropped after shade
        _, c_w = bin_by(sh.child_wavelength,
                        jnp.where(sh.child_alive, sh.child_power, 0.0))
        if cfg.roulette_threshold > 0.0:
            sh, _ = step_mod.roulette(sh, cfg, k)
        # GLOBAL top-k compaction over all 2*W*C children. A per-
        # wavelength-lane variant (W batched small top-ks, per-lambda cull
        # fairness) needs (W, 2C) take_along_axis gathers over the 12
        # child arrays. Under adequate headroom (zero cull) the two are
        # physically identical, so the simpler global form stays.
        new_rays, _ = step_mod.compact(sh, rays.capacity, cfg)
        _, live_after_w = bin_by(
            new_rays.wavelength,
            jnp.where(new_rays.alive, new_rays.power, 0.0))
        led_w = Ledger(
            emitted=led_w.emitted,
            measured=led_w.measured + m_w,
            absorbed=led_w.absorbed
            + (live_before_w - m_w - e_w - d_w - c_w),
            escaped=led_w.escaped + e_w,
            culled=led_w.culled + (c_w - live_after_w) + d_w,
        )
        return new_rays, det, per_dw, led_w, amp_w

    rays, det, per_dw, led_w, amp_w = jax.lax.fori_loop(
        0, iterations, body, (rays, det, per_dw, led_w, amp_w))
    if spectral_coherent:
        # drop the off-grid slot, unflatten to (W, 2, nb, nb)
        amp_w = amp_w[:, :, :nb * nb].reshape(W, 2, nb, nb)
    return rays, det, per_dw, led_w, amp_w


@functools.partial(jax.jit,
                   static_argnames=("cfg", "iterations", "n_detectors"))
def trace_spectral_dispersive_jit(scene: Scene, rays: RayBatch, wl_grid,
                                  cfg: TraceConfig, iterations: int,
                                  n_detectors: int, key=None):
    from lightpycl_tpu.tracer.rays import Ledger

    base_key = key if key is not None else jax.random.key(cfg.seed)
    rays, det, per_dw, led_w, amp_w = _dispersive_loop(
        scene, rays, wl_grid, cfg, iterations, n_detectors, base_key)
    led = Ledger(*(jnp.sum(x) for x in led_w))
    return rays, det, per_dw, led, led_w, amp_w


@functools.partial(jax.jit,
                   static_argnames=("cfg", "iterations", "n_detectors",
                                    "mesh"))
def trace_spectral_dispersive_multichip_jit(scene: Scene, rays: RayBatch,
                                            wl_grid, cfg: TraceConfig,
                                            iterations: int,
                                            n_detectors: int, mesh,
                                            key=None):
    """Sharded twin of trace_spectral_dispersive_jit: the flattened
    wavelength-stamped batch shards over the 1-D ray mesh (scene + grid
    replicated), each shard runs the dispersive loop locally, and the
    DetectorState, (D, W) spectra, and ledger psum over ICI."""
    from jax.sharding import PartitionSpec as P

    from lightpycl_tpu.parallel.sharding import RAY_AXIS
    from lightpycl_tpu.tracer.rays import Ledger

    base = key if key is not None else jax.random.key(cfg.seed)

    def local(scene, rays, wl, base):
        shard_key = jax.random.fold_in(base, jax.lax.axis_index(RAY_AXIS))
        rays, det, per_dw, led_w, amp_w = _dispersive_loop(
            scene, rays, wl, cfg, iterations, n_detectors, shard_key)
        det = DetectorState(*(jax.lax.psum(x, RAY_AXIS) for x in det))
        per_dw = jax.lax.psum(per_dw, RAY_AXIS)
        amp_w = jax.lax.psum(amp_w, RAY_AXIS)
        led_w = Ledger(*(jax.lax.psum(x, RAY_AXIS) for x in led_w))
        led = Ledger(*(jnp.sum(x) for x in led_w))
        return rays, det, per_dw, led, led_w, amp_w

    return jax.shard_map(local, mesh=mesh,
                         in_specs=(P(), P(RAY_AXIS), P(), P()),
                         out_specs=(P(RAY_AXIS), P(), P(), P(), P(), P()),
                         check_vma=False)(scene, rays, wl_grid, base)


def trace_spectral_dispersive(elements, rays: RayBatch, wavelengths,
                              weights=None, cfg: TraceConfig | None = None,
                              iterations: int = 8, key=None, mesh=None):
    """Wavelength-BATCHED trace for dispersive scenes (Cauchy glass,
    gratings — everything trace_spectral's shared-geometry model rejects).

    The W wavelengths each get a stamped copy of the ray batch
    (spread_rays_over_wavelengths) and ONE jitted trace of W * C rays
    runs them together: one compile, one dispatch, full device utilization
    — against W sequential scalar traces this removes per-trace dispatch
    latency and tail under-utilization (the intersection work itself is
    inherently W-fold, unlike the achromatic path's true W-for-1 sharing;
    see benchmarks/spectral_bench.py for measured numbers).

    Returns (per_det (D, W), Ledger (total power), detector_names, final
    RayBatch, DetectorState, per-wavelength Ledger — every entry a (W,)
    column conserving emitted[w] == measured[w] + absorbed[w] +
    escaped[w] + culled[w] + live_final[w]; the scalar Ledger is its
    column sum, and (W, 2, nb, nb) per-wavelength coherent field planes
    when cfg.coherent — each lambda interferes only with itself; summing
    the per-plane intensities gives the white-light pattern with its
    coherence envelope).

    `mesh` (optional 1-D jax.sharding.Mesh) shards the flattened batch
    over the ray axis — round-robin interleaved first, like every sharded
    path — with DetectorState / spectra / ledger psum'd over ICI.
    """
    from lightpycl_tpu.tracer.scene import build_scene

    cfg = cfg or TraceConfig()
    cfg = cfg.replace(
        has_coatings=any(e.coating_layers() for e in elements
                         if hasattr(e, "coating_layers")),
        has_gratings=any(e.material == Material.GRATING for e in elements),
        has_metals=any(getattr(e, "metal_n", 0.0) > 0.0 for e in elements),
        has_diffuse=any(e.material == Material.DIFFUSE for e in elements),
        has_analytic=any(getattr(e, "quad_abgd", None) is not None
                         for e in elements))
    if any(e.material in (Material.POLARIZER, Material.WAVEPLATE)
           for e in elements) and not cfg.polarization:
        raise ValueError("polarizer/waveplate elements need "
                         "TraceConfig(polarization=True)")
    if cfg.needs_rng and key is None:
        key = jax.random.key(cfg.seed)
    scene, det_names = build_scene(elements, spatial_sort=cfg.cull)
    wl = jnp.asarray(wavelengths, jnp.float32)
    if weights is None:
        weights = jnp.full((wl.shape[0],), 1.0 / wl.shape[0], jnp.float32)
    big = spread_rays_over_wavelengths(rays, wl, weights)
    if mesh is None:
        rays_out, det, per_dw, led, led_w, amp_w = \
            trace_spectral_dispersive_jit(
                scene, big, wl, cfg, iterations, len(det_names), key=key)
        return per_dw, led, det_names, rays_out, det, led_w, amp_w

    from jax.sharding import NamedSharding, PartitionSpec as P

    from lightpycl_tpu.parallel.sharding import (
        RAY_AXIS, deinterleave_rays, interleave_rays,
    )

    n_dev = mesh.devices.size
    if big.capacity % n_dev:
        big = big.padded_to(-(-big.capacity // n_dev) * n_dev)
    big = interleave_rays(big, n_dev)
    big = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P(RAY_AXIS))), big)
    rays_out, det, per_dw, led, led_w, amp_w = (
        trace_spectral_dispersive_multichip_jit(
            scene, big, wl, cfg, iterations, len(det_names), mesh,
            key=key))
    rays_out = deinterleave_rays(rays_out, n_dev)
    return per_dw, led, det_names, rays_out, det, led_w, amp_w


def _resolve_spectral(elements, cfg, wavelengths, weights):
    """Shared setup for the single-device and sharded entry points:
    validate the scene, sync every material flag from the elements (ONE
    place — new flags must be added here only), build the scene, default
    the weights."""
    from lightpycl_tpu.tracer.scene import build_scene

    validate_spectral_scene(elements)
    cfg = cfg or TraceConfig()
    cfg = cfg.replace(
        has_coatings=any(e.coating_layers() for e in elements
                         if hasattr(e, "coating_layers")),
        has_gratings=False, polarization=False, has_diffuse=False,
        has_metals=any(getattr(e, "metal_n", 0.0) > 0.0 for e in elements),
        has_analytic=any(getattr(e, "quad_abgd", None) is not None
                         for e in elements))
    scene, det_names = build_scene(elements, spatial_sort=cfg.cull)
    wl = jnp.asarray(wavelengths, jnp.float32)
    if weights is None:
        weights = jnp.full((wl.shape[0],), 1.0 / wl.shape[0], jnp.float32)
    return cfg, scene, det_names, wl, weights


def trace_spectral(elements, rays: RayBatch, wavelengths, weights=None,
                   cfg: TraceConfig | None = None, iterations: int = 8):
    """Trace one geometry pass carrying W spectral samples per ray.

    elements: GeoObjects (validated achromatic); rays: a RayBatch whose
    per-ray power is split over `wavelengths` (um) by `weights` (default
    uniform). Returns (per_detector (D, W), SpectralLedger, detector_names,
    final SpectralRays, DetectorState) — the DetectorState carries the
    angular histogram, per-detector row totals, and planar image of the
    ROW-TOTAL measured power, binned exactly like the scalar engine.
    """
    cfg, scene, det_names, wl, weights = _resolve_spectral(
        elements, cfg, wavelengths, weights)
    sr = SpectralRays.from_batch(rays, weights)
    sr, det, per_det, led = trace_spectral_jit(scene, sr, wl, cfg, iterations,
                                               len(det_names))
    return per_det, led, det_names, sr, det


@functools.partial(jax.jit,
                   static_argnames=("cfg", "iterations", "mesh",
                                    "n_detectors"))
def _trace_spectral_multichip_jit(scene, sr, wl, cfg, iterations, mesh,
                                  n_detectors):
    from jax.sharding import PartitionSpec as P

    from lightpycl_tpu.parallel.sharding import RAY_AXIS

    def local(scene, sr, wl):
        W = sr.P.shape[1]
        det = DetectorState.zeros(cfg.hist_azimuth_bins, cfg.hist_polar_bins,
                                  n_detectors, cfg.image_bins,
                                  n_tris=(scene.mat.shape[0] if cfg.flux_map
                                          else 0),
                                  time_bins=cfg.time_bins)
        per_det = jnp.zeros((max(n_detectors, 1), W), jnp.float32)
        z = jnp.zeros((W,), jnp.float32)
        led = SpectralLedger(
            emitted=jnp.sum(jnp.where(sr.alive[:, None], sr.P, 0.0),
                            axis=0),
            measured=z, absorbed=z, escaped=z, culled=z)

        def body(_, st):
            sr, det, per_det, led = st
            return spectral_step(scene, sr, det, per_det, led, wl, cfg)

        sr, det, per_det, led = jax.lax.fori_loop(0, iterations, body,
                                                  (sr, det, per_det, led))
        det = DetectorState(*(jax.lax.psum(x, RAY_AXIS) for x in det))
        per_det = jax.lax.psum(per_det, RAY_AXIS)
        led = SpectralLedger(*(jax.lax.psum(x, RAY_AXIS) for x in led))
        return sr, det, per_det, led

    return jax.shard_map(local, mesh=mesh,
                         in_specs=(P(), P(RAY_AXIS), P()),
                         out_specs=(P(RAY_AXIS), P(), P(), P()),
                         check_vma=False)(scene, sr, wl)


def trace_spectral_multichip(elements, rays: RayBatch, wavelengths,
                             weights=None, cfg: TraceConfig | None = None,
                             iterations: int = 8, mesh=None):
    """Spectral trace SPMD over a 1-D ray mesh: rays shard over chips
    (scene + wavelength grid replicated), each shard runs the
    wavelength-parallel loop locally, and the (D, W) per-detector spectra
    plus the per-wavelength ledger psum over ICI — the sharded twin of
    trace_spectral with the same return contract (final SpectralRays stay
    sharded; capacity is auto-padded to a multiple of the mesh size).

    Ray slots are INTERLEAVED round-robin across the shards before
    placement: RayBatch.from_arrays front-packs live rays, so contiguous
    block-sharding would pile every live ray (and every Fresnel-split
    child) onto the first shards while the dead-slot headroom sits idle
    on the tail shards — per-shard compaction would then cull real power
    that the single-device trace keeps. Ray order is semantically free,
    so the interleave is exact.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lightpycl_tpu.parallel.sharding import (
        RAY_AXIS, interleave_rays, make_ray_mesh,
    )

    cfg, scene, det_names, wl, weights = _resolve_spectral(
        elements, cfg, wavelengths, weights)
    mesh = mesh or make_ray_mesh()
    n_dev = mesh.devices.size
    if rays.capacity % n_dev:
        rays = rays.padded_to(-(-rays.capacity // n_dev) * n_dev)
    rays = interleave_rays(rays, n_dev)
    sr = SpectralRays.from_batch(rays, weights)
    sr = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P(RAY_AXIS))), sr)
    sr, det, per_det, led = _trace_spectral_multichip_jit(
        scene, sr, wl, cfg, iterations, mesh, len(det_names))
    return per_det, led, det_names, sr, det
