"""Generate docs/API.md: public signatures + docstring summaries."""

import importlib
import inspect
import sys

MODULES = [
    "lightpycl_tpu",
    "lightpycl_tpu.geometry.mesh",
    "lightpycl_tpu.geometry.primitives",
    "lightpycl_tpu.materials",
    "lightpycl_tpu.sources",
    "lightpycl_tpu.physics",
    "lightpycl_tpu.tracer.config",
    "lightpycl_tpu.tracer.rays",
    "lightpycl_tpu.tracer.scene",
    "lightpycl_tpu.tracer.step",
    "lightpycl_tpu.tracer.engine",
    "lightpycl_tpu.tracer.oracle",
    "lightpycl_tpu.ops.intersect_gpu",
    "lightpycl_tpu.parallel.sharding",
    "lightpycl_tpu.parallel.tri_sharding",
    "lightpycl_tpu.parallel.mesh2d",
    "lightpycl_tpu.parallel.distributed",
    "lightpycl_tpu.analysis",
    "lightpycl_tpu.paraxial",
    "lightpycl_tpu.diff",
    "lightpycl_tpu.spectral",
    "lightpycl_tpu.io.dxf",
    "lightpycl_tpu.io.stl",
    "lightpycl_tpu.io.ies",
    "lightpycl_tpu.io.obj",
    "lightpycl_tpu.io.rayfile",
    "lightpycl_tpu.io.zmx",
    "lightpycl_tpu.io.seq",
    "lightpycl_tpu.io.scene",
    "lightpycl_tpu.io.checkpoint",
    "lightpycl_tpu.compat",
    "lightpycl_tpu.utils.profiling",
]


def first_para(doc):
    if not doc:
        return ""
    return inspect.cleandoc(doc).split("\n\n")[0].replace("\n", " ")


def main():
    out = ["# API reference (generated by scripts/gen_api_docs.py)", ""]
    for name in MODULES:
        mod = importlib.import_module(name)
        out.append(f"## `{name}`")
        out.append("")
        out.append(first_para(mod.__doc__))
        out.append("")
        for attr, obj in sorted(vars(mod).items()):
            if attr.startswith("_") or getattr(obj, "__module__", None) != name:
                continue
            if inspect.isclass(obj):
                out.append(f"### class `{attr}`")
                out.append("")
                out.append(first_para(obj.__doc__))
                out.append("")
                for m_name, m in sorted(vars(obj).items()):
                    if m_name.startswith("_") or not callable(m):
                        continue
                    try:
                        sig = str(inspect.signature(m))
                    except (TypeError, ValueError):
                        sig = "(...)"
                    out.append(f"- `{attr}.{m_name}{sig}` — {first_para(m.__doc__)}")
                out.append("")
            elif inspect.isfunction(obj):
                try:
                    sig = str(inspect.signature(obj))
                except (TypeError, ValueError):
                    sig = "(...)"
                out.append(f"### `{attr}{sig}`")
                out.append("")
                out.append(first_para(obj.__doc__))
                out.append("")
    with open("docs/API.md", "w") as f:
        f.write("\n".join(out) + "\n")
    print(f"docs/API.md written ({len(out)} lines)")


if __name__ == "__main__":
    sys.exit(main())
