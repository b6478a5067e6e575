"""Experiment-config loading (counterpart of
``simpleaicv_tpu/core/config.py``).

An experiment is a directory holding ``train_config.py`` (and optionally
``test_config.py``) that defines ``class config``; ``load_config`` reads the
repository's own experiment directories, written for the JAX package.

Their source imports ``simpleaicv_tpu`` and its modules. ``load_config``
executes it with an ``__import__`` of its own in the module's builtins,
which resolves those imports to the port, ``simpleaicv_tpu_torch`` and its
modules of the same names, so the config builds the port's models, losses,
datasets and collaters. A sibling module of the config (``from train_config
import config`` in a ``test_config.py``) is loaded the same way; every other
import is Python's own. ``sys.modules`` gains no ``simpleaicv_tpu`` entry,
and a process may hold both packages.

A config that names something the port lacks raises
``MissingCounterpartError`` naming it; nothing is skipped.
"""

from __future__ import annotations

import builtins
import importlib
import os
import sys
import types

_JAX_PKG = "simpleaicv_tpu"
_PORT_PKG = "simpleaicv_tpu_torch"

__all__ = ["load_config", "config_repr", "MissingCounterpartError"]


class MissingCounterpartError(ImportError):
    """A config names a module or an object that the port has not ported."""


def _port_module(name: str, wanted):
    """The port's counterpart of ``simpleaicv_tpu[.sub]``; raises
    ``MissingCounterpartError`` naming ``wanted`` when there is none."""
    port = _PORT_PKG + name[len(_JAX_PKG):]
    try:
        return importlib.import_module(port)
    except ModuleNotFoundError as e:
        # only a missing counterpart itself, not a failure inside it
        if e.name is None or not (port == e.name
                                  or port.startswith(e.name + ".")):
            raise
        raise MissingCounterpartError(
            f"{', '.join(wanted)} (from {name}) has no counterpart in the "
            f"PyTorch port: {port} does not exist") from None


def _make_import(work_dir: str, loaded: dict):
    def port_import(name, globals=None, locals=None, fromlist=(), level=0):
        if level == 0 and (name == _JAX_PKG
                           or name.startswith(_JAX_PKG + ".")):
            module = _port_module(name, fromlist or (name,))
            for attr in fromlist or ():
                if attr == "*" or hasattr(module, attr):
                    continue
                try:
                    importlib.import_module(f"{module.__name__}.{attr}")
                except ModuleNotFoundError:
                    raise MissingCounterpartError(
                        f"{attr} (from {name}) has no counterpart in the "
                        f"PyTorch port: {module.__name__} has no {attr}"
                    ) from None
            if fromlist:
                return module
            return importlib.import_module(_PORT_PKG)
        if level == 0 and "." not in name and os.path.isfile(
                os.path.join(work_dir, name + ".py")):
            return _exec_module(work_dir, name, loaded)
        return builtins.__import__(name, globals, locals, fromlist, level)

    return port_import


def _exec_module(work_dir: str, module_name: str, loaded: dict):
    """Executes ``<work_dir>/<module_name>.py`` as a fresh module whose
    imports go through ``_make_import``; each module once per load."""
    if module_name in loaded:
        return loaded[module_name]
    path = os.path.join(work_dir, f"{module_name}.py")
    module = types.ModuleType(module_name)
    module.__file__ = path
    module.__builtins__ = dict(vars(builtins),
                               __import__=_make_import(work_dir, loaded))
    loaded[module_name] = module
    with open(path, encoding="utf-8") as f:
        code = compile(f.read(), path, "exec")
    exec(code, vars(module))  # noqa: S102 (the experiment's own config)
    return module


def load_config(work_dir: str, module_name: str = "train_config"):
    """``class config`` of ``<work_dir>/<module_name>.py``, built from the
    port's objects. Entries that the config adds to ``sys.path`` (its own
    directory, ``tools/``) are taken out again once it is loaded."""
    saved = list(sys.path)
    try:
        return _exec_module(os.path.abspath(work_dir), module_name,
                            {}).config
    finally:
        sys.path[:] = saved


def config_repr(config) -> str:
    rows = []
    for k in dir(config):
        if k.startswith("_"):
            continue
        v = getattr(config, k)
        rows.append(f"  {k}: {v!r}"[:200])
    return "config:\n" + "\n".join(rows)
