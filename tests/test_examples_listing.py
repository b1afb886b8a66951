"""The example sweep must not rot: every example_*.py on disk needs a
SMALL entry in examples/run_all.py (its reduced-size env), or the sweep
used to silently skip it while still reporting "all green" (run_all now
hard-fails on an unlisted file; this test makes the mismatch fail at
pytest time too)."""

import importlib.util
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
RUN_ALL = os.path.join(HERE, "..", "examples", "run_all.py")


@pytest.fixture(scope="module")
def run_all_mod():
    spec = importlib.util.spec_from_file_location("run_all_sweep", RUN_ALL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.smoke
class TestExampleListing:
    def test_every_example_listed(self, run_all_mod):
        unlisted, missing = run_all_mod.check_listing(
            run_all_mod.discover_examples(), run_all_mod.SMALL)
        assert unlisted == [], (
            f"examples missing a SMALL entry in examples/run_all.py: "
            f"{unlisted} — add reduced-size env vars so the sweep runs "
            "them")
        assert missing == [], (
            f"SMALL lists examples that do not exist: {missing}")

    def test_unlisted_example_fails_the_check(self, run_all_mod):
        unlisted, missing = run_all_mod.check_listing(
            {"example_a.py", "example_new.py"}, {"example_a.py": {}})
        assert unlisted == ["example_new.py"]
        assert missing == []

    def test_stale_listing_fails_the_check(self, run_all_mod):
        unlisted, missing = run_all_mod.check_listing(
            {"example_a.py"}, {"example_a.py": {}, "example_gone.py": {}})
        assert unlisted == []
        assert missing == ["example_gone.py"]
