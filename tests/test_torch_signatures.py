"""Every public function and class of the JAX package has its
counterpart in the port with the same call signature.

The public surface is what world_tpu, world_tpu.parallel,
world_tpu.utils, world_tpu.io and world_tpu.models export: their
``__all__`` names (a module among them stands for its public functions
and classes) or, where a package has no ``__all__``, the public
functions and classes of its modules.  For each, every parameter of the
JAX signature is in the port's with the same name and kind, and a
positional one at the same position; the port may add parameters
(``device``, keyword extras) after them.
"""

import importlib
import inspect
import pkgutil

import pytest

pytest.importorskip("torch")

PACKAGES = ("world_tpu", "world_tpu.parallel", "world_tpu.utils",
            "world_tpu.io", "world_tpu.models")


def _defined_in(module):
    return [n for n, v in vars(module).items()
            if not n.startswith("_")
            and (inspect.isfunction(v) or inspect.isclass(v))
            and v.__module__ == module.__name__]


def _public():
    """(module name, name) of every public function and class."""
    cases = set()
    for pkg_name in PACKAGES:
        pkg = importlib.import_module(pkg_name)
        names = getattr(pkg, "__all__", None)
        if names is None:
            for info in pkgutil.iter_modules(pkg.__path__):
                mod = importlib.import_module(f"{pkg_name}.{info.name}")
                cases.update((mod.__name__, n) for n in _defined_in(mod))
            continue
        for n in names:
            v = getattr(pkg, n)
            if inspect.ismodule(v):
                cases.update((v.__name__, m) for m in _defined_in(v))
            elif inspect.isfunction(v) or inspect.isclass(v):
                cases.add((pkg_name, n))
    return sorted(cases)


CASES = _public()


def test_surface_is_covered():
    """The walk finds the entry points the port's slices ported."""
    names = {n for _, n in CASES}
    for n in ("synthesis", "StreamingSynthesizer", "BatchedCorpusRunner",
              "make_mesh", "make_batch_step", "analyze_long",
              "allreduce_metrics", "wavread", "read_f0", "harvest"):
        assert n in names, n
    assert len(CASES) > 60


@pytest.mark.parametrize("module,name", CASES)
def test_port_accepts_the_jax_signature(module, name):
    jax_obj = getattr(importlib.import_module(module), name)
    port_mod = importlib.import_module(
        module.replace("world_tpu", "world_tpu_torch", 1))
    assert hasattr(port_mod, name), f"{module}.{name} has no port"
    theirs = list(inspect.signature(jax_obj).parameters.values())
    mine = list(inspect.signature(getattr(port_mod, name))
                .parameters.values())
    by_name = {p.name: p for p in mine}
    for i, p in enumerate(theirs):
        assert p.name in by_name, f"{name}: no parameter {p.name!r}"
        q = by_name[p.name]
        assert q.kind == p.kind, (name, p.name, q.kind, p.kind)
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            assert mine.index(q) == i, (name, p.name, mine.index(q), i)
