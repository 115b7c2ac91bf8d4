"""API documentation generator (stdlib-only).

The reference ships a Doxygen build with private-member extraction and a
gh-pages deploy (/root/reference/docs/CMakeLists.txt:1-13,
.github/workflows/docs.yml:27-42). This is the dependency-free equivalent:
walk the amg_jax package with importlib/inspect and emit one markdown page
per module (classes, functions, signatures, docstrings) plus an index, for
the docs workflow to publish.

Usage: python scripts/gen_api_docs.py [output_dir]   (default docs/api)
"""

from __future__ import annotations

import importlib
import inspect
import os
import pkgutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def _doc(obj) -> str:
    d = inspect.getdoc(obj)
    return d if d else "*(undocumented)*"


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def document_module(modname: str) -> str:
    mod = importlib.import_module(modname)
    lines = [f"# `{modname}`", "", _doc(mod), ""]
    members = [(n, m) for n, m in inspect.getmembers(mod)
               if not n.startswith("_")
               and getattr(m, "__module__", None) == modname]
    classes = [(n, m) for n, m in members if inspect.isclass(m)]
    funcs = [(n, m) for n, m in members if inspect.isfunction(m)]
    for name, cls in classes:
        lines += [f"## class `{name}`", "", _doc(cls), ""]
        for mname, meth in inspect.getmembers(cls):
            if mname.startswith("_") or not (inspect.isfunction(meth)
                                             or inspect.ismethod(meth)):
                continue
            if meth.__qualname__.split(".")[0] != name:
                continue  # inherited
            lines += [f"### `{name}.{mname}{_sig(meth)}`", "",
                      _doc(meth), ""]
    for name, fn in funcs:
        lines += [f"## `{name}{_sig(fn)}`", "", _doc(fn), ""]
    return "\n".join(lines)


def main(out_dir: str = "docs/api") -> list[str]:
    import amg_jax

    os.makedirs(out_dir, exist_ok=True)
    modnames = ["amg_jax"]
    for info in pkgutil.walk_packages(amg_jax.__path__,
                                      prefix="amg_jax."):
        if ".native" in info.name:
            continue  # requires a compiled extension at import time
        modnames.append(info.name)
    written = []
    for modname in sorted(modnames):
        try:
            text = document_module(modname)
        except Exception as e:  # document the failure, don't die
            text = f"# `{modname}`\n\nimport failed: {e}\n"
        fname = modname.replace(".", "_") + ".md"
        with open(os.path.join(out_dir, fname), "w") as f:
            f.write(text)
        written.append(fname)
    with open(os.path.join(out_dir, "index.md"), "w") as f:
        f.write("# amg_jax API reference\n\n")
        f.write("Generated by `scripts/gen_api_docs.py`.\n\n")
        for fname in written:
            mod = fname[:-3].replace("_", ".").replace("amg.jax", "amg_jax")
            f.write(f"- [{mod}]({fname})\n")
    print(f"wrote {len(written) + 1} pages to {out_dir}")
    return written


if __name__ == "__main__":
    main(*sys.argv[1:2])
