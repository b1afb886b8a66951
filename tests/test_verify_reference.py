"""scripts/verify_reference.py — the automated SURVEY.md §8 re-anchor
check. The real mount is empty, so the populated
path is exercised against synthetic reference trees."""

import importlib.util
import os
import textwrap

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SCRIPT = os.path.join(HERE, "..", "scripts", "verify_reference.py")


@pytest.fixture(scope="module")
def vr():
    spec = importlib.util.spec_from_file_location("verify_reference",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write(root, rel, text, pad=0, comment="#"):
    p = os.path.join(root, rel)
    os.makedirs(os.path.dirname(p), exist_ok=True)
    body = textwrap.dedent(text)
    body += "\n".join(f"{comment} pad {i}" for i in range(pad)) + "\n"
    with open(p, "w") as f:
        f.write(body)


class TestVerifyReference:
    def test_empty_mount_is_ok(self, vr, tmp_path, capsys):
        assert vr.main(["--reference", str(tmp_path)]) == 0
        assert "still empty" in capsys.readouterr().out

    def test_survey_consistent_mount_passes(self, vr, tmp_path, capsys):
        root = str(tmp_path)
        _write(root, "light_source.py", """
            def light_source(center, direction, directivity, power,
                             ray_count):
                pass
            """, pad=60)
        _write(root, "geo_optical_elements.py", """
            class GeoObject:
                def __init__(self, mesh, ior, mat_type):
                    pass
            class optical_elements:
                pass
            """, pad=260)
        _write(root, "iterative_tracer.py", """
            class CL_Tracer:
                def __init__(self, platform_name, device_type):
                    pass
                def iterative_tracer(self, light_source, meshes,
                                     trace_iterations, max_ray_len,
                                     ior_env):
                    pass
            """, pad=200)
        _write(root, "kernel_reflect_refract_intersect.cl", """
            #define EPSILON 1e-5
            // mirror = 1, refractive = 2, terminator = 3, measure = 4
            // cross product, determinant, barycentric test
            // fresnel split: reflect and refract children
            """, pad=200, comment="//")
        assert vr.main(["--reference", root]) == 0
        out = capsys.readouterr().out
        assert "epsilon candidate" in out
        assert "all survey anchors consistent" in out

    def test_missing_api_and_unexpected_capability_flagged(
            self, vr, tmp_path, capsys):
        root = str(tmp_path)
        # no CL_Tracer, and a BVH the survey says must not exist
        _write(root, "iterative_tracer.py", """
            class SomethingElse:
                pass
            # we build a BVH acceleration structure here
            # cross determinant barycentric fresnel reflect refract
            """, pad=200)
        _write(root, "light_source.py", "def light_source(): pass\n",
               pad=50)
        _write(root, "geo_optical_elements.py",
               "class GeoObject: pass\nclass optical_elements: pass\n",
               pad=250)
        _write(root, "kernel_reflect_refract_intersect.cl",
               "// EPSILON = 1e-5\n", pad=200, comment="//")
        assert vr.main(["--reference", root]) == 1
        out = capsys.readouterr().out
        assert "CL_Tracer" in out
        assert "BVH" in out
