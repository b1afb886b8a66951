"""Trace-state checkpoint / resume.

Reference parity: the reference has NO checkpointing (SURVEY.md §5.4 —
longest runs are seconds); this is the cheap extension the
survey recommends for the 100M-ray mega-batch config: ray batches are
independent, so a long run snapshots (ray SoA, detector bins, power ledger,
batch cursor) to npz and resumes batch-exactly.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from lightpycl_tpu.tracer.rays import DetectorState, Ledger, RayBatch

# bump when RayBatch/DetectorState/Ledger fields change meaning; loaders
# may forward-fill fields ADDED since an older version but must never
# guess at incompatible ones
SCHEMA_VERSION = 4  # v3 adds DetectorState.image_amp (coherent imaging);
#   v4 adds DetectorState.tri_flux (per-facet incident-flux maps) and
#   DetectorState.time_hist (time-of-flight histograms) — all forward-fill
#   to zeros when resuming older checkpoints


def normalize_path(path: str) -> str:
    """The on-disk name save_state actually writes (np.savez appends
    '.npz' when the suffix is missing — resume must check the same name)."""
    return path if path.endswith(".npz") else path + ".npz"


def save_state(path: str, rays: Optional[RayBatch] = None,
               detector: Optional[DetectorState] = None,
               ledger: Optional[Ledger] = None, **extra) -> str:
    """Snapshot trace state to an .npz file. Any of the three state pytrees
    may be omitted; `extra` holds scalars like the batch cursor. Returns
    the path actually written (always '.npz'-suffixed)."""
    path = normalize_path(path)
    payload: dict = {f"extra_{k}": np.asarray(v) for k, v in extra.items()}
    payload["extra_schema_version"] = np.asarray(SCHEMA_VERSION)
    if rays is not None:
        for f in RayBatch._fields:
            payload[f"rays_{f}"] = np.asarray(getattr(rays, f))
    if detector is not None:
        for f in DetectorState._fields:
            payload[f"det_{f}"] = np.asarray(getattr(detector, f))
    if ledger is not None:
        for f in Ledger._fields:
            payload[f"led_{f}"] = np.asarray(getattr(ledger, f))
    np.savez_compressed(path, **payload)
    return path


from lightpycl_tpu.tracer.rays import default_basis as _default_basis
# ^ rays whose checkpoint predates the `basis` field get the SAME frame
#   RayBatch.from_arrays builds (a zero fill would silently corrupt Stokes
#   rotation on resume into a polarization=True run)


def load_state(path: str):
    """Returns dict with 'rays' / 'detector' / 'ledger' (None if absent)
    and 'extra' (dict of scalars, including 'schema_version').

    Checkpoints newer than this build are refused; fields this build added
    since an older checkpoint are forward-filled with physically valid
    defaults (unpolarized Stokes, perpendicular basis frame)."""
    path = normalize_path(path)
    z = np.load(path)
    version = int(z["extra_schema_version"]) if "extra_schema_version" in z else 1
    if version > SCHEMA_VERSION:
        raise ValueError(
            f"checkpoint {path!r} has schema version {version}, newer than "
            f"this build's {SCHEMA_VERSION}; refusing to guess at its fields")
    out = {"rays": None, "detector": None, "ledger": None, "extra": {}}
    if "rays_o" in z:
        n = z["rays_power"].shape[0]
        d = jnp.asarray(z["rays_d"])

        def _field(f):
            if f"rays_{f}" in z:
                return jnp.asarray(z[f"rays_{f}"])
            # fields added after the checkpoint was written: valid defaults
            if f == "basis":
                return _default_basis(d)
            if f == "wavelength":
                from lightpycl_tpu.tracer.rays import D_LINE_UM

                return jnp.full((n,), D_LINE_UM, jnp.float32)
            if f == "medium":
                # pre-fluorescence checkpoints: ambient (-1), not element 0
                return jnp.full((n,), -1.0, jnp.float32)
            return jnp.zeros((n,), jnp.float32)

        out["rays"] = RayBatch(*[_field(f) for f in RayBatch._fields])
    if "det_hist" in z:
        def _det_field(f):
            if f"det_{f}" in z:
                return jnp.asarray(z[f"det_{f}"])
            # fields added after the checkpoint was written: accumulation
            # starts from zero with the field's disabled-state shape
            # (v<=2 has no image_amp; v<=3 has no tri_flux/time_hist)
            if f == "tri_flux":
                return jnp.zeros((1,), jnp.float32)
            if f == "time_hist":
                return jnp.zeros((1, 1), jnp.float32)
            return jnp.zeros((2, 1, 1), jnp.float32)

        out["detector"] = DetectorState(
            *[_det_field(f) for f in DetectorState._fields])
    if "led_emitted" in z:
        out["ledger"] = Ledger(*[jnp.asarray(z[f"led_{f}"]) for f in Ledger._fields])
    for k in z.files:
        if k.startswith("extra_"):
            out["extra"][k[6:]] = z[k]
    return out
