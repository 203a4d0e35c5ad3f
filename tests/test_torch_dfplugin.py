"""The port's plugin registry (``dragonfly2_tpu_torch/pkg/dfplugin.py``)
against the JAX one (``dragonfly2_tpu/pkg/dfplugin.py``).

Both registries load one plugin directory (``df_plugin_*.py`` files, the
``register(reg)`` hook and the ``PLUGIN_TYPE/PLUGIN_NAME/create`` form, a
file that fails and a file that exposes neither) and answer ``names``,
``get`` and ``create`` alike. The entry-point group is the JAX one: a
plugin package is the deployment's, whichever package runs its roles.
Each subsystem that the JAX package wires to the registry resolves
through the port's: a scheduling config whose ``algorithm`` names an
evaluator plugin (its picks, over seeded peers, equal the JAX
scheduling's with the same plugin), a manager ``searcher_plugin`` and an
unknown source scheme (cached after the first lookup). The cases of
``tests/test_dfplugin.py`` run on both packages.
"""

from __future__ import annotations

import random
import textwrap

import pytest

import dragonfly2_tpu.pkg.dfplugin as jplugin
import dragonfly2_tpu_torch.pkg.dfplugin as pplugin

PKGS = {"jax": jplugin, "port": pplugin}


def _write(tmp_path, name: str, body: str) -> str:
    (tmp_path / f"df_plugin_{name}.py").write_text(textwrap.dedent(body))
    return str(tmp_path)


def _fresh(monkeypatch, plugin_dir: str) -> None:
    """Both packages' process registries fresh, reading ``plugin_dir``."""
    monkeypatch.setenv("DRAGONFLY_PLUGIN_DIR", plugin_dir)
    for mod in (jplugin, pplugin):
        monkeypatch.setattr(mod, "_default", mod.PluginRegistry())


def test_constants_match():
    for name in ("ENTRY_POINT_GROUP", "PLUGIN_FILE_PREFIX", "TYPE_SOURCE",
                 "TYPE_EVALUATOR", "TYPE_SEARCHER"):
        assert getattr(jplugin, name) == getattr(pplugin, name), name
    # The JAX group name, kept on purpose (see the module docstring).
    assert pplugin.ENTRY_POINT_GROUP == "dragonfly2_tpu.plugins"


def test_both_registries_load_one_plugin_dir(tmp_path):
    d = _write(tmp_path, "a_hook", """
        class Client:
            scheme = "myproto"

        def register(reg):
            reg.add("source", "MyProto", Client)
            reg.add("searcher", "near", lambda **kw: ("searcher", kw))
    """)
    _write(tmp_path, "b_attrs", """
        PLUGIN_TYPE = "evaluator"
        PLUGIN_NAME = "Scorer"

        def create(**kwargs):
            return ("evaluator", kwargs)
    """)
    _write(tmp_path, "c_broken", "raise RuntimeError('plugin import fails')\n")
    _write(tmp_path, "d_empty", "X = 1\n")
    (tmp_path / "not_a_plugin.py").write_text("raise SystemExit(3)\n")
    answers = []
    for mod in (jplugin, pplugin):
        reg = mod.PluginRegistry()
        reg.load(d)
        reg.load(d)                      # a directory loads once
        answers.append((
            {t: reg.names(t) for t in ("source", "evaluator", "searcher")},
            type(reg.create("source", "myproto")).__name__,
            reg.create("evaluator", "SCORER", config=1),
            reg.create("searcher", "near", a=2),
            reg.get("source", "absent")))
        with pytest.raises(LookupError, match="no evaluator plugin"):
            reg.create("evaluator", "absent")
        with pytest.raises(ValueError, match="unknown plugin type"):
            reg.add("kernel", "x", object)
    assert answers[0] == answers[1]
    assert answers[0][0] == {"source": ["myproto"], "evaluator": ["scorer"],
                             "searcher": ["near"]}


def test_a_missing_dir_and_env_are_ignored(tmp_path, monkeypatch):
    monkeypatch.delenv("DRAGONFLY_PLUGIN_DIR", raising=False)
    for mod in (jplugin, pplugin):
        reg = mod.PluginRegistry()
        reg.load(str(tmp_path / "absent"))
        assert reg.names("source") == []


# The cases of tests/test_dfplugin.py, on both packages.

@pytest.mark.parametrize("pkg", PKGS)
def test_plugin_dir_register_hook(pkg, tmp_path):
    d = _write(tmp_path, "myproto", """
        class FakeClient:
            scheme = "myproto"

        def register(reg):
            reg.add("source", "myproto", FakeClient)
    """)
    reg = PKGS[pkg].PluginRegistry()
    reg.load(d)
    assert type(reg.create("source", "myproto")).__name__ == "FakeClient"


@pytest.mark.parametrize("pkg", PKGS)
def test_plugin_attrs_form_and_names(pkg, tmp_path):
    d = _write(tmp_path, "scorer", """
        PLUGIN_TYPE = "evaluator"
        PLUGIN_NAME = "random-scorer"

        def create(**kwargs):
            return ("evaluator-instance", kwargs)
    """)
    reg = PKGS[pkg].PluginRegistry()
    reg.load(d)
    inst, kwargs = reg.create("evaluator", "random-scorer", config=None)
    assert inst == "evaluator-instance" and kwargs == {"config": None}
    assert reg.names("evaluator") == ["random-scorer"]


@pytest.mark.parametrize("pkg", PKGS)
def test_source_registry_resolves_plugin_scheme(pkg, tmp_path, monkeypatch):
    d = _write(tmp_path, "dfs", """
        class DfsClient:
            async def download(self, request):
                raise NotImplementedError

        def register(reg):
            reg.add("source", "dfs", DfsClient)
    """)
    _fresh(monkeypatch, d)
    if pkg == "jax":
        from dragonfly2_tpu.source.client import Registry
    else:
        from dragonfly2_tpu_torch.source.client import Registry
    reg = Registry()
    client = reg.get("dfs://cluster/path/to/shard")
    assert type(client).__name__ == "DfsClient"
    assert reg.get("dfs://other") is client          # cached
    with pytest.raises(Exception) as e:
        reg.get("nosuch://x")
    assert "no source client for scheme 'nosuch'" in str(e.value)


_EVALUATOR = """
    PLUGIN_TYPE = "evaluator"
    PLUGIN_NAME = "counting"

    def create(config=None):
        import importlib

        mod = config.__class__.__module__.split(".")[0]
        ev = importlib.import_module(
            mod + ".scheduler.scheduling.evaluator").Evaluator

        class Counting(ev):
            calls = 0

            def evaluate_parents(self, parents, child,
                                 total_piece_count=-1):
                self.calls += 1
                return list(reversed(super().evaluate_parents(
                    parents, child, total_piece_count)))

        return Counting(config)
"""


def _peers(pkg: str, n: int, seed: int):
    """A child and ``n`` parents on one task, their pieces seeded."""
    if pkg == "jax":
        from dragonfly2_tpu.scheduler.resource import Host, Peer, Task
    else:
        from dragonfly2_tpu_torch.scheduler.resource import Host, Peer, Task
    rng = random.Random(seed)
    task = Task("plugin-task", "http://o/x")
    task.total_piece_count = 16
    child = Peer("child", task, Host("hc", hostname="hc", ip="10.0.0.1"))
    parents = []
    for i in range(n):
        p = Peer(f"p{i}", task, Host(f"h{i}", hostname=f"h{i}",
                                     ip=f"10.0.1.{i}"))
        for num in range(rng.randint(0, 16)):
            p.finished_pieces.add(num)
        parents.append(p)
    return child, parents


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduling_with_an_evaluator_plugin_picks_alike(
        tmp_path, monkeypatch, seed):
    """``scheduling.algorithm`` naming a plugin builds the plugin's
    evaluator in both packages (wrapping each package's default), and
    its ordering of seeded parents is the same in both."""
    from dragonfly2_tpu.scheduler.config import SchedulingConfig as JCfg
    from dragonfly2_tpu.scheduler.scheduling import Scheduling as JSched
    from dragonfly2_tpu_torch.scheduler.config import SchedulingConfig
    from dragonfly2_tpu_torch.scheduler.scheduling import Scheduling

    _fresh(monkeypatch, _write(tmp_path, "counting", _EVALUATOR))
    jcfg = JCfg()
    jcfg.algorithm = "counting"
    picks = {}
    for pkg, sched in (("jax", JSched(jcfg)),
                       ("port", Scheduling(SchedulingConfig(
                           algorithm="counting")))):
        assert type(sched.evaluator).__name__ == "Counting"
        child, parents = _peers(pkg, 6, seed)
        ordered = sched.evaluator.evaluate_parents(parents, child, 16)
        picks[pkg] = [p.id for p in ordered]
        assert sched.evaluator.calls == 1
    assert picks["jax"] == picks["port"]


def test_an_unknown_algorithm_raises_lookup_error_in_both(tmp_path,
                                                           monkeypatch):
    from dragonfly2_tpu.scheduler.config import SchedulingConfig as JCfg
    from dragonfly2_tpu.scheduler.scheduling import Scheduling as JSched
    from dragonfly2_tpu_torch.scheduler.config import SchedulingConfig
    from dragonfly2_tpu_torch.scheduler.scheduling import Scheduling

    _fresh(monkeypatch, str(tmp_path))
    jcfg = JCfg()
    jcfg.algorithm = "absent"
    msgs = []
    for make in (lambda: JSched(jcfg),
                 lambda: Scheduling(SchedulingConfig(algorithm="absent"))):
        with pytest.raises(LookupError) as e:
            make()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "no evaluator plugin named 'absent'"


def test_a_manager_searcher_plugin_resolves_in_both(tmp_path, monkeypatch):
    from dragonfly2_tpu.manager.service import ManagerService as JService
    from dragonfly2_tpu_torch.manager.service import ManagerService

    _fresh(monkeypatch, _write(tmp_path, "searcher", """
        PLUGIN_TYPE = "searcher"
        PLUGIN_NAME = "first-cluster"

        class First:
            def find_scheduler_clusters(self, clusters, *a, **k):
                return list(clusters)[:1]

        def create():
            return First()
    """))
    j = JService(searcher_plugin="first-cluster")
    p = ManagerService(searcher_plugin="first-cluster")
    assert type(j.searcher).__name__ == type(p.searcher).__name__ == "First"
    assert p.searcher.find_scheduler_clusters([3, 4]) == [3]
    j.db.close()
    p.db.close()
