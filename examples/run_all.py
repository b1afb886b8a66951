"""Run every example at reduced size (CI-style sweep).

    JAX_PLATFORMS=cpu python examples/run_all.py     # CPU, ~3 min
    python examples/run_all.py                      # GPU
"""

import os
import runpy
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

SMALL = {
    "example_parabolic_mirror.py": {"RAY_COUNT": "20000"},
    "example_plano_convex.py": {"RAY_COUNT": "100000"},
    "example_lens_stack.py": {"RAY_COUNT": "5000"},
    "example_prism_dispersion.py": {"RAY_COUNT": "4000"},
    "example_polarization.py": {"RAY_COUNT": "4000"},
    "example_asphere.py": {"RAY_COUNT": "4000"},
    "example_michelson.py": {"RAY_COUNT": "4000"},
    "example_spectrometer.py": {"RAY_COUNT": "4000"},
    "example_straylight.py": {"RAY_COUNT": "20000"},
    "example_coated_mla.py": {"RAY_COUNT": "20000"},
    "example_lens_design.py": {"OPT_STEPS": "12"},
    "example_spectral_coating.py": {"RAY_COUNT": "2000", "N_WL": "16"},
    "example_led_collimator.py": {"RAY_COUNT": "10000"},
    "example_newtonian.py": {"RAY_COUNT": "4000"},
    "example_birefringence.py": {"RAY_COUNT": "4000"},
    "example_tolerancing.py": {"RAY_COUNT": "1500", "N_MC": "8"},
    "example_turbid.py": {"RAY_COUNT": "8000"},
    "example_white_led.py": {"RAY_COUNT": "6000"},
    "example_rough_mirror.py": {"RAY_COUNT": "8000"},
    "example_grin.py": {"RAY_COUNT": "1000"},
    "example_schmidt.py": {"RAY_COUNT": "1500"},
    # sized for the CPU jnp reference; on the GPU bump via env before running
    "example_large_mesh.py": {"TOTAL_RAYS": "200000", "BATCH": "100000",
                              "MESH_SEGMENTS": "48",
                              "CKPT": os.path.join(tempfile.gettempdir(),
                                                   "run_all_ckpt.npz")},
    "example_multichip.py": {"RAY_COUNT": "16384"},
    "example_fresnel_lens.py": {"RAY_COUNT": "4000"},
    "example_coating_design.py": {"OPT_STEPS": "300"},
    "example_bestform.py": {"OPT_STEPS": "20"},
    "example_aberrations.py": {"RAY_COUNT": "1024"},
    "example_zmx.py": {"RAY_COUNT": "3000"},
    "example_cassegrain.py": {"RAY_COUNT": "3000"},
    "example_field_sweep.py": {"RAY_COUNT": "2048"},
    "example_codev.py": {"RAY_COUNT": "4000"},
}


def discover_examples():
    """All example_*.py files on disk (basenames)."""
    import glob

    return {os.path.basename(p)
            for p in glob.glob(os.path.join(HERE, "example_*.py"))}


def check_listing(on_disk, listed):
    """(unlisted, missing) — every on-disk example must have a SMALL
    entry and every SMALL entry must exist. Both lists must be empty."""
    return (sorted(set(on_disk) - set(listed)),
            sorted(set(listed) - set(on_disk)))


def main():
    # Every example_*.py on disk MUST have a SMALL entry (its reduced-size
    # env) — a new example that isn't listed used to be silently skipped,
    # letting "all green" rot. Fail loudly instead.
    unlisted, missing = check_listing(discover_examples(), SMALL)
    if unlisted or missing:
        if unlisted:
            print(f"ERROR: example(s) not listed in SMALL (add a "
                  f"reduced-size env entry): {unlisted}")
        if missing:
            print(f"ERROR: SMALL lists example(s) that do not exist: "
                  f"{missing}")
        return 2

    failures = []
    for name, env in SMALL.items():
        os.environ.update(env)
        if name == "example_large_mesh.py" and os.path.exists(env.get("CKPT", "")):
            os.remove(env["CKPT"])
        t0 = time.perf_counter()
        print(f"=== {name} ===", flush=True)
        try:
            runpy.run_path(os.path.join(HERE, name), run_name="__main__")
            print(f"=== {name} OK ({time.perf_counter() - t0:.1f}s) ===",
                  flush=True)
        except Exception as e:  # noqa: BLE001 - report and continue
            failures.append((name, repr(e)))
            print(f"=== {name} FAILED: {e!r} ===", flush=True)
    if failures:
        print(f"{len(failures)} example(s) failed: {failures}")
        return 1
    print(f"all {len(SMALL)} examples OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
