"""Detector-accumulation A/B: the shipped XLA scatter-add against
jax.ops.segment_sum.

  scatter   shipped path: .at[flat].add(power) (atomics on the GPU)
  segsum    jax.ops.segment_sum with num_segments=B

Each variant computes the SAME (648-bin angular hist + per-detector
totals) from C measured rays; timed as chained reps inside one jitted
scan. Each row reports its error against float64 host sums.

Prints one JSON line per variant (full size on a GPU, a smoke size
elsewhere).
"""

import json
import os
import sys
import time


def main():
    from lightpycl_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp
    import numpy as np

    on_gpu = jax.default_backend() == "gpu"
    C = int(os.environ.get("RAY_COUNT", 1 << 22 if on_gpu else 1 << 12))
    reps = int(os.environ.get("REPS", 8 if on_gpu else 2))
    n_az, n_pol, n_det = 36, 18, 4
    B = n_az * n_pol

    rng = np.random.default_rng(0)
    hit = jnp.asarray(rng.normal(size=(C, 3)), jnp.float32)
    power = jnp.asarray(rng.uniform(0, 1e-6, (C,)), jnp.float32)
    det_id = jnp.asarray(rng.integers(0, n_det, C), jnp.int32)

    def bins_of(v):
        v = v / jnp.linalg.norm(v, axis=1, keepdims=True)
        az = jnp.arctan2(v[:, 1], v[:, 0])
        az = jnp.where(az < 0, az + 2.0 * np.pi, az)
        pol = jnp.arccos(jnp.clip(v[:, 2], -1.0, 1.0))
        ia = jnp.clip((az / (2 * np.pi) * n_az).astype(jnp.int32), 0,
                      n_az - 1)
        ip = jnp.clip((pol / np.pi * n_pol).astype(jnp.int32), 0,
                      n_pol - 1)
        return ia * n_pol + ip

    def scatter(v, p, did):
        flat = bins_of(v)
        hist = jnp.zeros((B,), jnp.float32).at[flat].add(p)
        per = jnp.zeros((n_det,), jnp.float32).at[did].add(p)
        return hist, per

    def segsum(v, p, did):
        flat = bins_of(v)
        hist = jax.ops.segment_sum(p, flat, num_segments=B)
        per = jax.ops.segment_sum(p, did, num_segments=n_det)
        return hist, per

    # correctness anchor: float64 host sums. Variant-vs-variant f32
    # comparison is the wrong oracle at this size — a 1M-term f32 sum's
    # error depends on accumulation ORDER, so two correct variants
    # legitimately differ by ~1e-4 relative. Each row reports its own
    # f64-relative err.
    flat_h = np.asarray(bins_of(hit))
    p_h = np.asarray(power, np.float64)
    hist_ref = np.zeros(B)
    np.add.at(hist_ref, flat_h, p_h)
    per_ref = np.zeros(n_det)
    np.add.at(per_ref, np.asarray(det_id), p_h)

    for name, fn in (("scatter", scatter), ("segsum", segsum)):
        @jax.jit
        def loop(v, p, did, fn=fn):
            def body(c, _):
                h, pr = fn(v + c, p, did)
                return jnp.clip(h.sum(), 0.0, 1.0) * 1e-30, (h.sum(),
                                                             pr.sum())
            return jax.lax.scan(body, jnp.float32(0.0), None, length=reps)

        h0, p0 = fn(hit, power, det_id)
        h0, p0 = np.asarray(h0, np.float64), np.asarray(p0, np.float64)
        err_h = float(np.abs(h0 - hist_ref).max()
                      / max(np.abs(hist_ref).max(), 1e-30))
        err_p = float(np.abs(p0 - per_ref).max()
                      / max(np.abs(per_ref).max(), 1e-30))
        assert err_h < 1e-3 and err_p < 1e-3, (name, err_h, err_p)
        jax.block_until_ready(loop(hit, power, det_id))
        hit2 = jax.block_until_ready(hit + jnp.float32(1e-7))
        t0 = time.perf_counter()
        jax.block_until_ready(loop(hit2, power, det_id))
        dt = (time.perf_counter() - t0) / reps
        print(json.dumps({"variant": name, "rays": C,
                          "device_kind": jax.devices()[0].device_kind,
                          "ms_per_call": dt * 1e3,
                          "rays_per_s": C / dt,
                          "rel_err_vs_f64": max(err_h, err_p)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
