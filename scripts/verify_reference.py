"""SURVEY.md §8 re-anchoring, automated.

The reference mount `/root/reference/` was EMPTY at survey time (SURVEY.md
§0), so every capability claim is anchored to BASELINE.json + recalled
knowledge. If the mount is ever populated, this script runs the §8
checklist mechanically and prints a re-anchor report:

  1. file census + LoC vs the survey's ~LoC estimates (§2/§3),
  2. public signatures the compat shim freezes (light_source,
     CL_Tracer.iterative_tracer, the optical_elements factory methods),
  3. kernel epsilon constants + material-code integer mapping,
  4. capability greps the survey flagged as verify-before-relying
     (DXF import, polarization, dispersion, BVH/acceleration).

Exit status: 0 = mount still empty (nothing to do) or populated with no
mismatches; 1 = populated and at least one survey anchor needs re-work
(each mismatch is printed with the SURVEY.md section to update).

Usage:  python scripts/verify_reference.py [--reference /root/reference]
"""

from __future__ import annotations

import argparse
import ast
import os
import re
import sys

SURVEY_ESTIMATES = {
    # SURVEY.md §3 component table: file -> (~LoC estimate, slack factor)
    "geo_optical_elements.py": (620, 3.0),   # GeoObject ~120 + factory ~500
    "light_source.py": (150, 3.0),
    "iterative_tracer.py": (450, 3.0),
    "kernel_reflect_refract_intersect.cl": (450, 3.0),
}

# SURVEY.md §3: signatures the compat shim (lightpycl_tpu/compat.py)
# freezes. Names are checked for existence; kwargs are listed for the
# report, not asserted (the survey tags them [med]).
EXPECT_CALLABLES = {
    "light_source.py": ["light_source"],
    "geo_optical_elements.py": ["GeoObject", "optical_elements"],
    "iterative_tracer.py": ["CL_Tracer"],
}

CAPABILITY_GREPS = [
    # (label, regex, SURVEY anchor, expected-in-survey: bool)
    ("DXF import (dxfgrabber)", r"dxfgrabber|readfile", "§8.5 [low]", False),
    ("polarization", r"[Ss]tokes|polariz", "§8.5 [believed absent]", False),
    ("wavelength dispersion", r"dispers|sellmeier|cauchy",
     "§8.5 [believed absent]", False),
    ("BVH / acceleration structure", r"\bBVH\b|kd.?tree|octree",
     "§8.5 [believed absent]", False),
    ("Moller-Trumbore intersect", r"cross|determinant|barycentric",
     "§3 intersect kernel [high]", True),
    ("Fresnel power split", r"[Ff]resnel", "§3 reflect/refract [high]",
     True),
    ("ray splitting (2 children)", r"reflect.*refract|refract.*reflect",
     "§3 reflect/refract [high]", True),
]

EPSILON_RE = re.compile(  # covers `eps = 1e-5`, `#define EPSILON 1e-5`
    r"(?:EPSILON|[Ee]ps\w*)\s*(?:[=:]\s*|\s+)"
    r"([0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)")
MATERIAL_RE = re.compile(
    r"(mirror|refract\w*|terminat\w*|measur\w*|dissipat\w*)\W{0,20}?"
    r"([0-9]+)", re.IGNORECASE)


def census(root):
    files = {}
    for dirpath, _dirnames, filenames in os.walk(root):
        for f in filenames:
            p = os.path.join(dirpath, f)
            try:
                with open(p, errors="replace") as fh:
                    files[os.path.relpath(p, root)] = fh.read()
            except OSError:
                pass
    return files


def loc(text):
    return sum(1 for ln in text.splitlines() if ln.strip())


def toplevel_names(text):
    try:
        tree = ast.parse(text)
    except SyntaxError:
        return set()
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
    return names


def signature_report(text, wanted):
    """For each wanted name present, pull its def/init signature line."""
    lines = []
    try:
        tree = ast.parse(text)
    except SyntaxError:
        return lines
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                and node.name in wanted:
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, ast.FunctionDef) and \
                            sub.name in ("__init__", "iterative_tracer"):
                        args = [a.arg for a in sub.args.args]
                        lines.append(f"  {node.name}.{sub.name}"
                                     f"({', '.join(args)})")
            else:
                args = [a.arg for a in node.args.args]
                lines.append(f"  {node.name}({', '.join(args)})")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reference", default="/root/reference")
    args = ap.parse_args(argv)

    files = census(args.reference)
    if not files:
        print(f"reference mount {args.reference} is still empty — "
              "SURVEY.md remains the blueprint of record (§0); nothing "
              "to re-anchor.")
        return 0

    print(f"reference mount POPULATED: {len(files)} files — running the "
          "SURVEY.md §8 re-anchor checklist.\n")
    problems = []

    # 1. census + LoC
    total = 0
    print("== file census (re-anchor §2/§3 ~LoC and [recalled] line "
          "ranges against this) ==")
    for rel in sorted(files):
        n = loc(files[rel])
        total += n
        print(f"  {n:6d}  {rel}")
        base = os.path.basename(rel)
        if base in SURVEY_ESTIMATES:
            est, slack = SURVEY_ESTIMATES[base]
            if not (est / slack <= n <= est * slack):
                problems.append(
                    f"{base}: {n} LoC vs survey estimate ~{est} "
                    f"(outside {slack}x slack) — update SURVEY.md §3")
    print(f"  total: {total} LoC (survey §0 estimate: ~2-3 kLoC)\n")
    if not 500 <= total <= 10000:
        problems.append(
            f"total LoC {total} far from the survey's 2-3k estimate — "
            "the fork may differ structurally from upstream; re-survey")

    # 2. expected files + public signatures
    basenames = {os.path.basename(p): p for p in files}
    print("== expected public API (freeze compat.py against these) ==")
    for fname, names in EXPECT_CALLABLES.items():
        if fname not in basenames:
            problems.append(
                f"survey-expected file {fname} missing from the mount "
                "(renamed/split? re-anchor SURVEY.md §2 layer map)")
            continue
        text = files[basenames[fname]]
        have = toplevel_names(text)
        for n in names:
            if n not in have:
                problems.append(
                    f"{fname}: expected public name {n!r} not found — "
                    "re-anchor SURVEY.md §3 + compat.py")
        for line in signature_report(text, set(names)):
            print(line)
    print()

    # 3. kernel epsilons + material codes
    print("== kernel constants (compare with TraceConfig.eps/eps_bary "
          "and materials.Material) ==")
    for rel, text in files.items():
        if rel.endswith(".cl") or "kernel" in rel:
            for m in EPSILON_RE.finditer(text):
                print(f"  {rel}: epsilon candidate {m.group(0).strip()}")
            for m in MATERIAL_RE.finditer(text):
                print(f"  {rel}: material-code candidate "
                      f"{m.group(1)} = {m.group(2)}")
    print()

    # 4. capability greps
    print("== capability checks (SURVEY.md §8.5) ==")
    blob = "\n".join(files.values())
    for label, pat, anchor, expected in CAPABILITY_GREPS:
        hit = re.search(pat, blob) is not None
        mark = "present" if hit else "absent"
        print(f"  {label}: {mark}  (survey: {anchor})")
        if hit != expected:
            problems.append(
                f"capability {label!r} is {mark} but the survey "
                f"says otherwise ({anchor}) — re-anchor and check the "
                "build covers it")

    print()
    if problems:
        print(f"{len(problems)} anchor(s) need re-work:")
        for p in problems:
            print(f"  - {p}")
        return 1
    print("all survey anchors consistent with the populated mount.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
