"""Test config: run everything on CPU jax with an 8-device virtual mesh.

The suite runs on CPU jax (the GPU kernel in the Pallas interpreter) with
sharding tested on a virtual 8-device CPU mesh
(--xla_force_host_platform_device_count). Tests that need the card carry
the `gpu` marker and skip here; `python chip_smoke.py` covers them on the
GPU.
"""

import os

# must be set before jax initializes its backends
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# the suite is CPU-only, also on a machine with a GPU
jax.config.update("jax_platforms", "cpu")

# Harden against rare XLA-CPU compiler segfaults on the largest modules
# late in long sessions (observed twice at ~90% of the full suite, both
# in trace_spectral's compile; the same test passes standalone):
# (a) raise the stack limit before the compiler's worker threads spawn,
# (b) persistent compile cache so repeat runs skip the big compiles
#     entirely (also a large suite-time win).
import resource  # noqa: E402

try:
    _soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
    resource.setrlimit(resource.RLIMIT_STACK, (_hard, _hard))
except (ValueError, OSError):
    pass

# (c) XLA:CPU keeps a (rw-, r-x, r--) mmap triple per live compiled
# executable; the full suite accumulates ~60k mappings and segfaults
# mid-compile when it crosses the kernel default vm.max_map_count=65530
# (diagnosed by watching /proc/<pid>/maps grow to the limit right where
# the crashes happened). Raise it when running as root; ignore failures.
try:
    with open("/proc/sys/vm/max_map_count") as _f:
        if int(_f.read()) < 1_000_000:
            with open("/proc/sys/vm/max_map_count", "w") as _f:
                _f.write("4000000")
except (OSError, ValueError):
    pass
from lightpycl_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (never here: the suite is CPU-only).
    `python chip_smoke.py` runs the same checks on the card."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py covers this on the card")


# --------------------------------------------------------------------------
# Smoke tier: `pytest -m smoke` runs one representative test per subsystem
# in < 5 min (the full suite is ~35-47 min on this 1-core box — see
# CLAUDE.md). Centralized here as (file, test-function) pairs so adding a
# test never requires touching the test body; parametrized ids match on
# the bare function name.
# --------------------------------------------------------------------------

SMOKE_TESTS = {
    ("test_tracer.py", "test_collimation_and_power"),
    ("test_geometry.py", "test_sphere_area_and_normals"),
    ("test_sources.py", "test_power_normalized"),
    ("test_physics.py", "test_snell_angle"),
    ("test_intersect.py", "test_direct_hit"),
    ("test_compaction.py", "test_stream_overflow_conserves"),
    ("test_sharding.py", "test_matches_single_device"),
    ("test_tri_sharding.py", "test_matches_unsharded"),
    ("test_mesh2d.py", "test_mesh2d_roulette_conserves"),
    ("test_checkpoint.py", "test_roundtrip_identity"),
    ("test_batched.py", "test_batched_conserves_and_measures"),
    ("test_analysis.py", "test_histogram_conserves_power"),
    ("test_dxf.py", "test_polyface_roundtrip_traces_identically"),
    ("test_cull.py", "test_collimated_bundle"),
    ("test_native.py", "test_native_matches_numpy"),
    ("test_diff.py", "test_power_conserved_through_diff_path"),
    ("test_polarization.py", "test_split_conserves_energy"),
    ("test_coating.py", "test_quarter_wave_minimum"),
    ("test_grin.py", "test_quarter_pitch_focuses_collimated_beam"),
    ("test_compat.py", "test_full_reference_script"),
    ("test_parity_oracle.py", "test_config1_parabolic_collimator"),
    ("test_edge_cases.py", "test_grazing_incidence_conserves"),
    ("test_spectral.py", "test_per_wavelength_conservation_exact"),
    ("test_analytic.py", "test_plano_convex_focal_length"),
    ("test_flux_map.py", "test_sphere_uniform_irradiance"),
    ("test_time_hist.py", "test_direct_flight_single_bin"),
    ("test_paraxial.py", "test_unit_determinant"),
    ("test_ies.py", "test_isotropic_uniform_candela"),
    ("test_rayfile.py", "test_round_trip_all_blocks"),
    ("test_obj_ply.py", "test_round_trip"),
    ("test_zmx.py", "test_singlet_matches_thick_lens"),
    ("test_zmx.py", "test_cassegrain_paraxial"),
    ("test_seq.py", "test_singlet_matches_thick_lens"),
    ("test_scene_io.py", "test_every_field_survives"),
    ("test_scene_scale.py", "test_telescope_scene_expands_pow2"),
    ("test_field_sweep.py", "test_line_foci_synthetic"),
}


def pytest_collection_modifyitems(config, items):
    found = set()
    for item in items:
        key = (item.fspath.basename, item.name.split("[")[0])
        if key in SMOKE_TESTS:
            item.add_marker(pytest.mark.smoke)
            found.add(key)
    # rot guard: a renamed/removed smoke test must fail loudly, not
    # silently shrink the tier (only judge files that were collected, so
    # single-file runs don't false-alarm)
    collected = {item.fspath.basename for item in items}
    stale = {k for k in SMOKE_TESTS if k[0] in collected} - found
    if stale:
        raise pytest.UsageError(
            f"conftest SMOKE_TESTS entries not found (renamed/removed?): "
            f"{sorted(stale)}")
