"""The plugin loader: the port's copy of ``dragonfly2_tpu/pkg/dfplugin.py``.

Source clients, evaluators and searchers from outside the package, loaded
from two places:

1. **A plugin directory** (``DRAGONFLY_PLUGIN_DIR`` or an explicit path):
   every ``df_plugin_*.py`` file in it is imported and registered.
2. **Entry points** of the group ``dragonfly2_tpu.plugins``: the JAX
   package's group, kept so that one installed plugin package serves a
   deployment whichever package runs its roles.

A plugin module exposes::

    PLUGIN_TYPE = "source" | "evaluator" | "searcher"
    PLUGIN_NAME = "myscheme"          # the scheme of a source, else a name
    def create(**kwargs): ...         # the client / evaluator / searcher

or a single ``register(registry)`` function for full control.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import threading

from dragonfly2_tpu_torch.pkg import dflog

log = dflog.get("pkg.dfplugin")

ENTRY_POINT_GROUP = "dragonfly2_tpu.plugins"
PLUGIN_FILE_PREFIX = "df_plugin_"

TYPE_SOURCE = "source"
TYPE_EVALUATOR = "evaluator"
TYPE_SEARCHER = "searcher"


class PluginRegistry:
    def __init__(self):
        self._factories: dict[tuple[str, str], object] = {}
        self._loaded_dirs: set[str] = set()
        self._entry_points_loaded = False
        self._lock = threading.Lock()

    # -- registration (called by plugins) ----------------------------------

    def add(self, plugin_type: str, name: str, factory) -> None:
        if plugin_type not in (TYPE_SOURCE, TYPE_EVALUATOR, TYPE_SEARCHER):
            raise ValueError(f"unknown plugin type {plugin_type!r}")
        self._factories[(plugin_type, name.lower())] = factory
        log.info("plugin registered", type=plugin_type, name=name)

    # -- lookup (called by subsystems) -------------------------------------

    def get(self, plugin_type: str, name: str):
        """The factory of (type, name), or None. Loads the plugin sources
        on first use."""
        self.load()
        return self._factories.get((plugin_type, name.lower()))

    def create(self, plugin_type: str, name: str, **kwargs):
        factory = self.get(plugin_type, name)
        if factory is None:
            raise LookupError(f"no {plugin_type} plugin named {name!r}")
        return factory(**kwargs) if callable(factory) else factory

    def names(self, plugin_type: str) -> list[str]:
        self.load()
        return sorted(n for t, n in self._factories if t == plugin_type)

    # -- loading -----------------------------------------------------------

    def load(self, plugin_dir: str | None = None) -> None:
        with self._lock:
            self._load_entry_points()
            for d in (plugin_dir, os.environ.get("DRAGONFLY_PLUGIN_DIR")):
                if d:
                    self._load_dir(d)

    def _load_entry_points(self) -> None:
        if self._entry_points_loaded:
            return
        self._entry_points_loaded = True
        try:
            from importlib.metadata import entry_points

            for ep in entry_points(group=ENTRY_POINT_GROUP):
                try:
                    self._register_module(ep.load())
                except Exception:
                    log.error("entry-point plugin failed", name=ep.name,
                              exc_info=True)
        except Exception:
            pass

    def _load_dir(self, plugin_dir: str) -> None:
        plugin_dir = os.path.abspath(plugin_dir)
        if plugin_dir in self._loaded_dirs or not os.path.isdir(plugin_dir):
            return
        self._loaded_dirs.add(plugin_dir)
        for fname in sorted(os.listdir(plugin_dir)):
            if not (fname.startswith(PLUGIN_FILE_PREFIX)
                    and fname.endswith(".py")):
                continue
            mod_name = f"_df_plugins.{fname[:-3]}"
            path = os.path.join(plugin_dir, fname)
            try:
                spec = importlib.util.spec_from_file_location(mod_name, path)
                module = importlib.util.module_from_spec(spec)
                sys.modules[mod_name] = module
                spec.loader.exec_module(module)
                self._register_module(module)
            except Exception:
                log.error("plugin file failed", path=path, exc_info=True)

    def _register_module(self, module) -> None:
        register = getattr(module, "register", None)
        if callable(register):
            register(self)
            return
        ptype = getattr(module, "PLUGIN_TYPE", None)
        name = getattr(module, "PLUGIN_NAME", None)
        create = getattr(module, "create", None)
        if ptype and name and create:
            self.add(ptype, name, create)
        else:
            log.warning("plugin exposes neither register() nor "
                        "PLUGIN_TYPE/PLUGIN_NAME/create",
                        module=getattr(module, "__name__", "?"))


_default = PluginRegistry()


def registry() -> PluginRegistry:
    return _default


def load(plugin_dir: str | None = None) -> PluginRegistry:
    _default.load(plugin_dir)
    return _default
