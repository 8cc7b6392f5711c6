"""The port's package surface against the JAX package's.

An AST walk over the reference ``__init__.py`` files (no JAX is imported):
every name such a file exports must resolve on the port's package of the
same path, unless it is in :data:`MISSING`, the explicit list of names
whose module the port does not have yet, each with the item of ROADMAP.md
queue 1 that will port it. A listed name must not resolve: the list stays
exact as modules land. A last case walks every module of the port (and
``chip_smoke.py``) by AST and fails on an import of ``jax`` or
``pyqed_tpu``.
"""
import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "pyqed_tpu"
PORT = ROOT / "pyqed_tpu_torch"
PACKAGES = ("", "ops", "core", "open", "grid", "models", "signal", "utils",
            "floquet", "tn", "control", "qchem", "negf", "qmc", "md", "ml")

BEAM = "queue 1 item 5 (beam/, with utils/style and cli.py)"
PARALLEL = "queue 1 item 6 (parallel/)"

_STYLE = ("set_style", "subplots", "curve", "matplot", "imshow",
          "level_scheme", "two_scales", "surf", "plot_surface",
          "plot_surfaces", "export", "read_result")
MISSING = {
    **{("", n): BEAM for n in _STYLE},
    ("", "parallel"): PARALLEL, ("", "beam"): BEAM,
    ("utils", "style"): BEAM,
}


def _module_names(path):
    """Public names a star import of the module at ``path`` binds."""
    tree = ast.parse(path.read_text())
    out = []
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return list(ast.literal_eval(node.value))
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.append(node.name)
        elif isinstance(node, ast.Assign):
            out += [n.id for t in node.targets for n in ast.walk(t)
                    if isinstance(n, ast.Name)]
        elif isinstance(node, ast.ImportFrom) and node.level:
            out += [a.asname or a.name for a in node.names if a.name != "*"]
    return [n for n in out if not n.startswith("_")]


def _source(pkg_dir, module):
    """The source file of ``module`` (a module or a package's
    ``__init__.py``) inside ``pkg_dir``, None where there is none."""
    base = pkg_dir.joinpath(*module.split(".")) if module else pkg_dir
    for cand in (base.with_suffix(".py"), base / "__init__.py"):
        if cand.exists():
            return cand
    return None


def exports(pkg):
    """(name, defining module relative to the package) of every name the
    reference ``__init__.py`` of ``pkg`` exports."""
    pkg_dir = REF.joinpath(*pkg.split(".")) if pkg else REF
    tree = ast.parse((pkg_dir / "__init__.py").read_text())
    out = []
    for node in tree.body:
        if not isinstance(node, ast.ImportFrom) or node.level != 1:
            continue
        mod = node.module or ""
        for a in node.names:
            if a.name == "*":
                src = _source(pkg_dir, mod)
                names = ([n for n, _ in exports(f"{pkg}.{mod}".strip("."))]
                         if src.name == "__init__.py"
                         else _module_names(src))
                out += [(n, mod) for n in names]
            elif not mod:
                out.append((a.asname or a.name, a.name))
            else:
                out.append((a.asname or a.name, mod))
    return out


def _resolves(pkg, name):
    mod = importlib.import_module(
        "pyqed_tpu_torch" + (f".{pkg}" if pkg else ""))
    return hasattr(mod, name)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_reference_exports_resolve_on_the_port(pkg):
    unresolved = []
    for name, _ in exports(pkg):
        if (pkg, name) in MISSING:
            assert not _resolves(pkg, name), \
                f"{pkg or 'top'}.{name} is ported: drop it from MISSING"
        elif not _resolves(pkg, name):
            unresolved.append(name)
    assert not unresolved, (f"pyqed_tpu_torch{'.' + pkg if pkg else ''} "
                            f"lacks {unresolved}")


def test_missing_names_are_reference_exports():
    exported = {(pkg, n) for pkg in PACKAGES for n, _ in exports(pkg)}
    assert set(MISSING) <= exported, set(MISSING) - exported


def _imported_roots(path):
    """The top-level package of every absolute import in ``path``."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = {str(f.relative_to(ROOT)): sorted(
        _imported_roots(f) & {"jax", "jaxlib", "pyqed_tpu"})
        for f in files}
    assert len(files) > 100
    assert not {k: v for k, v in bad.items() if v}, bad
