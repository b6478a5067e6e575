"""Every name that an experiment config imports from the JAX package has
a counterpart in the port, read from the configs' source with ``ast``
and not executed (executing the 241 bodies would build SAM-H and the
other full-size models): for each ``from simpleaicv_tpu[.sub] import X``
of each ``experiments/**/*_config.py``, ``simpleaicv_tpu_torch[.sub]``
imports and holds ``X`` (an attribute or a submodule), which is what
``core/config.py::load_config`` resolves. One case per task family.
"""

import ast
import glob
import importlib
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERIMENTS = os.path.join(REPO, "experiments")
FAMILIES = sorted(os.listdir(EXPERIMENTS))


def _configs(family):
    return sorted(glob.glob(os.path.join(EXPERIMENTS, family, "**",
                                         "*_config.py"), recursive=True))


def _jax_imports(path):
    """(line, module, name) of each import from the JAX package."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0 and (
                node.module == "simpleaicv_tpu"
                or node.module.startswith("simpleaicv_tpu.")):
            out += [(node.lineno, node.module, a.name) for a in node.names]
        elif isinstance(node, ast.Import):
            out += [(node.lineno, a.name, None) for a in node.names
                    if a.name.split(".")[0] == "simpleaicv_tpu"]
    return out


def _has_counterpart(module, name):
    port = "simpleaicv_tpu_torch" + module[len("simpleaicv_tpu"):]
    try:
        mod = importlib.import_module(port)
    except ModuleNotFoundError:
        return False
    if name is None or name == "*" or hasattr(mod, name):
        return True
    try:
        importlib.import_module(f"{port}.{name}")
    except ModuleNotFoundError:
        return False
    return True


def test_families_hold_every_config():
    assert len(FAMILIES) == 15
    assert sum(len(_configs(f)) for f in FAMILIES) == len(glob.glob(
        os.path.join(EXPERIMENTS, "**", "*_config.py"), recursive=True))


@pytest.mark.parametrize("family", FAMILIES)
def test_config_imports_resolve_in_the_port(family):
    configs = _configs(family)
    assert configs
    missing, n = [], 0
    for path in configs:
        for line, module, name in _jax_imports(path):
            n += 1
            if not _has_counterpart(module, name):
                missing.append(f"{os.path.relpath(path, REPO)}:{line}: "
                               f"{name} from {module}")
    assert n > 0
    assert not missing, "\n".join(missing)
