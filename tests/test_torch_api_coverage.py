"""Audit: every public name of the JAX package has its counterpart in the
port, module by module, read from the source by ``ast`` (neither package
is imported by the audit).

A JAX module's public names are those it defines at top level (functions,
classes, assignments, also under ``if``/``try``), the package names it
re-exports (the imports of a package ``__init__`` and those marked
``noqa: F401``) and the names a module ``__getattr__`` serves (the keys of
the dict literal it holds). Each must be bound in the port's module at
the same path: defined, imported or served by its ``__getattr__``. Two
mappings apply: ``ops/pallas/<name>_pallas.py`` -> ``ops/cuda/<name>.py``
(``*_pallas`` -> ``*_cuda``), and ``utils/__init__.py`` -> ``utils.py``.
The only exceptions are in ``EXCLUDED``, each with its reason. Each
parameter of a public JAX function or method must be accepted by its
counterpart too, but the XLA-only ones (``XLA_ONLY_PARAMETERS``).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "iv_interpolation_tpu"
PORT_PKG = REPO / "iv_interpolation_tpu_torch"

EXCLUDED = {
    "ops/df64.py": "parity mode runs in float64 on the card, keeping the (w_grid, "
                   "w_grid_lo) contract (models/spline.py) without double-float32 arithmetic",
    "ops/spline_compensated.py": "the double-float32 spline of parity mode; the port's "
                                 "parity mode is float64 (models/spline.py)",
    "parallel/shardproof.py:cpu_subprocess_env": "sets JAX platform variables for CPU "
                                                 "subprocesses; the port's shard processes "
                                                 "take --device",
}


def _port_path(rel: str) -> str:
    parts = rel.split("/")
    if parts[:2] == ["ops", "pallas"]:
        return "ops/cuda/" + parts[2].replace("_pallas.py", ".py")
    return {"utils/__init__.py": "utils.py"}.get(rel, rel)


def _port_name(rel: str, name: str) -> str:
    return name.replace("_pallas", "_cuda") if rel.startswith("ops/pallas/") else name


def _served(node) -> set:
    """String keys of the dict literals under ``node``."""
    return {k.value for n in ast.walk(node) if isinstance(n, ast.Dict)
            for k in n.keys if isinstance(k, ast.Constant) and isinstance(k.value, str)}


def _names(path: Path, reexports_only: bool) -> set:
    """Top-level public names of a module. With ``reexports_only`` an
    import counts only as a re-export (package ``__init__`` or
    ``noqa: F401``, from this package); else every binding counts."""
    text = path.read_text()
    lines = text.splitlines()
    out = set()

    def walk(body):
        for s in body:
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                out.add(s.name)
                if s.name == "__getattr__":
                    out.update(_served(s))
            elif isinstance(s, (ast.Assign, ast.AnnAssign)):
                targets = s.targets if isinstance(s, ast.Assign) else [s.target]
                names = {n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)}
                out.update(names)
                if "__getattr__" in names:
                    out.update(_served(s.value))
                if "__all__" in names and isinstance(s.value, (ast.List, ast.Tuple)):
                    out.update(e.value for e in s.value.elts if isinstance(e, ast.Constant))
            elif isinstance(s, (ast.Import, ast.ImportFrom)):
                own = isinstance(s, ast.ImportFrom) and (
                    s.level or (s.module or "").startswith("iv_interpolation_tpu"))
                marked = "noqa: F401" in "\n".join(lines[s.lineno - 1:s.end_lineno])
                if not reexports_only or (own and (path.name == "__init__.py" or marked)):
                    out.update((a.asname or a.name).split(".")[0] for a in s.names)
            elif isinstance(s, (ast.If, ast.Try, ast.With)):
                walk(s.body)
                walk(getattr(s, "orelse", []))
                for h in getattr(s, "handlers", []):
                    walk(h.body)
                walk(getattr(s, "finalbody", []))

    walk(ast.parse(text).body)
    return {n for n in out if not n.startswith("_")}


JAX_MODULES = sorted(p.relative_to(JAX_PKG).as_posix() for p in JAX_PKG.rglob("*.py"))

# Parameters of the JAX package that only XLA or Pallas read (ROADMAP A7,
# "Do not port"): loop unrolling, the Pallas aggregation switch and its
# interpret mode and tick tile, the compile-wall slot cap, the compilation
# cache, JAX device lists, the calibration batch of a compile estimate.
XLA_ONLY_PARAMETERS = {"unroll", "lm_unroll", "use_pallas_agg", "max_slots", "cache_dir",
                       "devices", "n_devices", "calibrate_rows", "interpret", "l_tile"}


def _signatures(path: Path) -> dict:
    """Public top-level functions and public classes' ``__init__`` and
    public methods: name -> (parameter names, takes ``**kwargs``)."""
    out = {}

    def add(name, fn):
        a = fn.args
        out[name] = ({x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}
                     | ({a.vararg.arg} if a.vararg else set()), a.kwarg is not None)

    for s in ast.parse(path.read_text()).body:
        if isinstance(s, ast.FunctionDef) and not s.name.startswith("_"):
            add(s.name, s)
        elif isinstance(s, ast.ClassDef) and not s.name.startswith("_"):
            for f in s.body:
                if isinstance(f, ast.FunctionDef) and (f.name == "__init__"
                                                       or not f.name.startswith("_")):
                    add(f"{s.name}.{f.name}", f)
    return out


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_name_has_its_counterpart(rel):
    if rel in EXCLUDED:
        assert not (PORT_PKG / rel).exists(), f"{rel} is excluded but ported"
        return
    port = PORT_PKG / _port_path(rel)
    assert port.is_file(), f"no counterpart of {rel} at {port.relative_to(REPO)}"
    have = _names(port, reexports_only=False)
    missing = sorted(n for n in _names(JAX_PKG / rel, reexports_only=True)
                     if _port_name(rel, n) not in have and f"{rel}:{n}" not in EXCLUDED)
    assert not missing, f"{rel}: no counterpart in {_port_path(rel)} for {missing}"


@pytest.mark.parametrize("rel", [r for r in JAX_MODULES if r not in EXCLUDED])
def test_every_parameter_name_is_accepted(rel):
    """Each parameter of a public JAX function or method is a parameter of
    its counterpart (or goes to its ``**kwargs``), but the XLA-only ones."""
    have = _signatures(PORT_PKG / _port_path(rel))
    missing = []
    for name, (params, _) in _signatures(JAX_PKG / rel).items():
        mine = have.get(_port_name(rel, name))
        if mine is None:
            continue                     # a method the port spells otherwise
        takes, any_kw = mine
        missing += [f"{name}({p})" for p in sorted(params - takes - XLA_ONLY_PARAMETERS)
                    if not any_kw]
    assert not missing, f"{rel}: parameters without a counterpart: {missing}"


@pytest.mark.parametrize("key", sorted(EXCLUDED))
def test_each_exclusion_is_still_needed(key):
    """An excluded module or name exists in the JAX package and not in the
    port: a stale exclusion fails here."""
    rel, _, name = key.partition(":")
    assert (JAX_PKG / rel).is_file()
    if name:
        assert name in _names(JAX_PKG / rel, reexports_only=True)
        assert name not in _names(PORT_PKG / _port_path(rel), reexports_only=False)
    else:
        assert not (PORT_PKG / _port_path(rel)).exists()


def test_the_light_entry_points_import_neither_torch_nor_jax():
    """The package, the monitor's module (its side process) and the
    manifests load without torch or JAX."""
    code = ("import sys; import iv_interpolation_tpu_torch, "
            "iv_interpolation_tpu_torch.monitoring.monitor, "
            "iv_interpolation_tpu_torch.pipeline.manifest; "
            "from iv_interpolation_tpu_torch import Config, get_config; "
            "print(sorted(m for m in ('torch', 'jax') if m in sys.modules))")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
