"""Exact-surface differentiable design: stigmatic conic + Coddington
best form.

geometry/analytic.py surfaces intersect EXACTLY on device (no
tessellation), and their differentiable twin (diff.analytic_singlet_scene
+ diff.quadric_intersect_diff) carries gradients of curvature, conic
constant, and thickness with no facet noise. That unlocks two classic
third-order results the meshed path cannot resolve (see the tessellation
note in example_lens_design.py and the ROADMAP negative result):

 1. Stigmatic singlet: flat front, conic exit. Gradient descent on the
    conic constant from a SPHERE rediscovers the Descartes hyperbola
    k = -n^2 to ~1e-3, and the spot collapses to f32 noise (~1e-7 RMS —
    the meshed version bottoms out at its facet floor ~6e-3).
 2. Coddington best form: at fixed power, scan the shape factor
    q = (c1 + c2)/(c1 - c2); the spot-RMS minimum falls in a basin
    around the thin-lens optimum q* = 2(n^2 - 1)/(n + 2) ~ 0.714.

    JAX_PLATFORMS=cpu python examples/example_bestform.py
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

from lightpycl_tpu import diff

N_GLASS = 1.5
STEPS = int(os.environ.get("OPT_STEPS", 60))

# ---------------------------------------------------------------- demo 1
print("=== demo 1: rediscover the stigmatic conic k = -n^2 (exact surfaces)")
f, t_c = 3.0, 0.15
c2 = -1.0 / ((N_GLASS - 1.0) * f)
loss_full = diff.make_analytic_spot_loss(ior=N_GLASS, thickness=t_c,
                                         aperture_radius=0.6, n_rays=300,
                                         beam_fill=0.75)
loss = jax.jit(lambda k2: loss_full(0.0, c2, 0.0, k2, t_c + f))
vg = jax.jit(jax.value_and_grad(loss))

k2 = jnp.float32(0.0)
opt = optax.adam(0.15)
state = opt.init(k2)
best_v, best_k = float(loss(k2)), float(k2)
print(f"  start (sphere):  k2 = {best_k:+.4f}   spot rms = {best_v:.3e}")
t0 = time.time()
for i in range(STEPS):
    v, g = vg(k2)
    if float(v) < best_v:
        best_v, best_k = float(v), float(k2)
    upd, state = opt.update(g, state)
    k2 = optax.apply_updates(k2, upd)
print(f"  after {STEPS} adam steps ({time.time() - t0:.1f}s):")
print(f"  k2 = {best_k:+.4f}   (theory -n^2 = {-N_GLASS**2:+.4f})")
print(f"  spot rms = {best_v:.3e}  (sphere was {float(loss(0.0)):.3e})")

# ---------------------------------------------------------------- demo 2
print("=== demo 2: Coddington best-form shape scan (f/5 singlet)")
X = 2.0  # c1 - c2: thin-lens power (n-1)X = 1
lf = diff.make_analytic_spot_loss(ior=N_GLASS, thickness=0.05,
                                  aperture_radius=0.3, n_rays=300,
                                  beam_fill=0.33)
zs = jnp.linspace(0.9, 1.2, 61)
batch = jax.jit(jax.vmap(
    lambda z, q: lf(X * (q + 1) / 2, X * (q - 1) / 2, 0.0, 0.0, z),
    in_axes=(0, None)))
qs = np.linspace(0.0, 1.4, 8)
vals = [float(jnp.min(batch(zs, float(q)))) for q in qs]
q_star = 2.0 * (N_GLASS**2 - 1.0) / (N_GLASS + 2.0)
for q, v in zip(qs, vals):
    mark = "  <- thin-lens q* ~ 0.714" if abs(q - 0.6) < 0.11 else ""
    print(f"  q = {q:+.2f}   best spot rms = {v:.3e}{mark}")
print(f"  scan minimum at q = {qs[int(np.argmin(vals))]:+.2f} "
      f"(thin-lens theory q* = {q_star:.3f}; thick-lens and fifth-order "
      "terms shift it within the basin)")
