"""Generate per-module API reference pages (docs/api/*.md) from docstrings.

The reference ships Sphinx autodoc pages (reference docs/source/api/);
this emits the same per-module API surface as plain markdown so the docs
stay dependency-free.  Run from the repo root:

    JAX_PLATFORMS=cpu python tools/gen_api_docs.py
"""

import importlib
import inspect
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "docs", "api")

MODULES = {
    "core": [
        "pymgrit_tpu.core.solver",
        "pymgrit_tpu.core.at_mgrit",
        "pymgrit_tpu.core.application",
        "pymgrit_tpu.core.vector",
        "pymgrit_tpu.core.grid_transfer",
        "pymgrit_tpu.core.hierarchy",
        "pymgrit_tpu.core.levels",
        "pymgrit_tpu.core.partition",
    ],
    "models": [
        "pymgrit_tpu.models.dahlquist",
        "pymgrit_tpu.models.heat_1d",
        "pymgrit_tpu.models.heat_1d_2pts",
        "pymgrit_tpu.models.heat_2d",
        "pymgrit_tpu.models.advection_1d",
        "pymgrit_tpu.models.arenstorf_orbit",
        "pymgrit_tpu.models.brusselator",
        "pymgrit_tpu.models.allen_cahn",
        "pymgrit_tpu.models.gray_scott_2d",
        "pymgrit_tpu.models.diffusion_2d",
        "pymgrit_tpu.models.burgers",
        "pymgrit_tpu.models.grid_transfer_heat",
        "pymgrit_tpu.models.induction_machine",
    ],
    "parallel": [
        "pymgrit_tpu.parallel.sharding",
        "pymgrit_tpu.parallel.shard_solver",
    ],
    "ops": [
        "pymgrit_tpu.ops.dd",
        "pymgrit_tpu.ops.ozaki",
        "pymgrit_tpu.ops.dirichlet_spectral",
        "pymgrit_tpu.ops.runge_kutta",
        "pymgrit_tpu.ops.prefix",
    ],
    "utils": [
        "pymgrit_tpu.utils.plots",
        "pymgrit_tpu.coupling.callback",
    ],
}


def _sig(obj):
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj, indent=""):
    d = inspect.getdoc(obj)
    if not d:
        return ""
    return "\n".join(indent + line for line in d.splitlines())


def render_module(modname: str) -> str:
    mod = importlib.import_module(modname)
    lines = [f"## `{modname}`", ""]
    d = _doc(mod)
    if d:
        lines += [d, ""]
    members = [(n, o) for n, o in vars(mod).items()
               if not n.startswith("_") and getattr(o, "__module__", None) == modname]
    for name, obj in members:
        if inspect.isclass(obj):
            lines += [f"### class `{name}{_sig(obj)}`", ""]
            d = _doc(obj)
            if d:
                lines += [d, ""]
            # the class heading already shows the constructor signature
            for mname, meth in inspect.getmembers(obj):
                if mname.startswith("_"):
                    continue
                if not (inspect.isfunction(meth) or inspect.ismethod(meth)):
                    continue
                if meth.__qualname__.split(".")[0] != name:
                    continue    # inherited: documented on the base class
                lines += [f"#### `{name}.{mname}{_sig(meth)}`", ""]
                d = _doc(meth)
                if d:
                    lines += [d, ""]
        elif inspect.isfunction(obj):
            lines += [f"### `{name}{_sig(obj)}`", ""]
            d = _doc(obj)
            if d:
                lines += [d, ""]
    return "\n".join(lines)


def main():
    os.makedirs(OUT, exist_ok=True)
    index = ["# API reference", "",
             "Generated from docstrings by `tools/gen_api_docs.py` "
             "(the markdown analogue of the reference's Sphinx autodoc "
             "pages, `/root/reference/docs/source/api/`).", ""]
    for page, mods in MODULES.items():
        parts = [f"# `pymgrit_tpu` — {page}", ""]
        for mn in mods:
            parts.append(render_module(mn))
            parts.append("")
        path = os.path.join(OUT, f"{page}.md")
        with open(path, "w") as f:
            f.write("\n".join(parts))
        index.append(f"- [{page}]({page}.md): " + ", ".join(
            f"`{m.split('.')[-1]}`" for m in mods))
        print("wrote", path)
    with open(os.path.join(OUT, "index.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    print("wrote", os.path.join(OUT, "index.md"))


if __name__ == "__main__":
    main()
