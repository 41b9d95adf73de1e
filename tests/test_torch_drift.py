"""The JAX package's static drift checks (``scripts/check_*.py``), held
on the port's operator surface.

The JAX package wires fifteen checks as tier-1 tests, each holding one
surface of its code against its registry and its docs.  This file holds
the port's code against the port's registries with the same rules, and
the port's registries against the JAX package's own (the JAX checks
already hold those against the docs).  Every test reads sources or
imports registries; none builds a model.

* Fault sites: every ``fault_point`` / ``fault_data`` / storage site
  literal of the port (the JAX check's ``_CALL_RE`` and ``_DISK_RE``) is
  in ``SITES``, every entry of ``SITES`` has a call site, and ``SITES``
  is the JAX set but :data:`SITES_NOT_PORTED`; the kinds are equal.
* Metric names: every metric-name literal (the JAX check's ``_NAME_RE``)
  is in ``CATALOG``, every entry of ``CATALOG`` is emitted, and
  ``CATALOG`` is the JAX catalog but :data:`METRICS_NOT_PORTED`.
* Span and event names: the ``span("…")`` literals equal the JAX set;
  the ``event="…"`` literals equal it but :data:`EVENTS_NOT_PORTED` and
  :data:`EVENTS_PORT_ONLY`.
* The operator flags: each flag maps to a real keyword, field or knob of
  the port's counterpart, with the JAX check's own map, and each
  registry and constructor equals the JAX one.
* The commands: every subcommand's flags, defaults and choices are the
  JAX command's but :data:`FLAGS_NOT_PORTED`, ``--platform`` →
  ``--device`` and :data:`FLAG_ATTRS_DIFFER`.
* Fusible stages, the kernel registry, the mesh axes, the ``SNTC_*``
  switches (the JAX set but :data:`ENV_NOT_READ`).

A difference that is not named in one of the not-ported constants fails
a test until it is repaired or named there with its reason.

Run it alone on the CPU: ``python -m pytest tests/test_torch_drift.py
-q`` (a few seconds).
"""

import argparse
import ast
import dataclasses
import importlib
import importlib.util
import inspect
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "sntc_tpu_torch")
JAX = os.path.join(REPO, "sntc_tpu")

#: the JAX package's fault sites whose code the port does not have
SITES_NOT_PORTED = {
    "probe.init": "the backend probe; the north star leaves it out",
    "fuse.compile": "segments launch eagerly: no segment program compiles",
    "kernel.compile": "the kernel poison ladder; the no-fallback rule",
}
#: the JAX package's series that count what the port does not do
METRICS_NOT_PORTED = {
    "sntc_device_fallback_batches_total": "no host fallback (no-fallback "
                                          "rule)",
    "sntc_device_poisoned_signatures": "no signature poisoning "
                                       "(no-fallback rule)",
    "sntc_device_recoveries_total": "no recovery probe: a failed device "
                                    "stays failed (no-fallback rule)",
    "sntc_kernel_fallback_total": "no twin path beside a kernel "
                                  "(no-fallback rule)",
    "sntc_kernel_poisoned_signatures": "no kernel poison ladder "
                                       "(no-fallback rule)",
}
#: the JAX package's events of the host fallback and the poison ladder
EVENTS_NOT_PORTED = {
    "device_degraded": "no HOST_DEGRADED state (no-fallback rule)",
    "device_recovered": "no recovery probe (no-fallback rule)",
    "kernel_poisoned": "no kernel poison ladder (no-fallback rule)",
    "signature_poisoned": "no signature poisoning (no-fallback rule)",
}
#: the port's events in their place
EVENTS_PORT_ONLY = {
    "device_failed": "the device domain failed: every dispatch raises",
    "daemon_device_failed": "the daemon drains every tenant and exits 1",
}
#: (subcommand, JAX flag) pairs the port does not take
FLAGS_NOT_PORTED = {
    ("serve", "--serve-kernels"): "the kernel switch; no-fallback rule",
    ("serve", "--compile-budget-s"): "the compile watchdog; north star",
    ("serve-daemon", "--compile-budget-s"): "the compile watchdog; "
                                            "north star",
    ("fleet-serve", "--compile-budget-s"): "the compile watchdog; "
                                           "north star",
    ("fsck", "--compile-cache"): "the compile cache; north star",
    ("fsck", "--compile-cache-dir"): "the compile cache; north star",
    ("fsck", "--platform"): "steers only the backend probe; north star",
    ("fleet-restore-retired", "--platform"): "steers only the backend "
                                             "probe; north star",
}
#: the JAX flag each port flag replaces
FLAGS_RENAMED = {"--platform": "--device"}
#: (subcommand, flag, attribute) the port sets otherwise
FLAG_ATTRS_DIFFER = {
    ("train", "--metric", "choices"): "the metric is checked at parsing",
    ("evaluate", "--metric", "choices"): "the metric is checked at "
                                         "parsing",
}
#: the ``SNTC_*`` switches the JAX package reads and the port does not
ENV_NOT_READ = {
    "SNTC_CACHE_NO_HOST_KEY": "the compile cache; north star",
    "SNTC_NO_COMPILE_CACHE": "the compile cache; north star",
    "SNTC_PROBE_ATTEMPTS": "the backend probe; north star",
    "SNTC_PROBE_TIMEOUT_S": "the backend probe; north star",
    "SNTC_RECOVERY_PROBE_TIMEOUT_S": "the recovery probe; north star",
    "SNTC_SERVE_KERNELS": "turns kernels off; no-fallback rule",
    "SNTC_TREE_HIST": "turns the histogram kernel off; no-fallback rule",
    "SNTC_CHECKPOINT_FORMAT": "orbax checkpoints; npz only in the port",
    "SNTC_PEAK_BW": "still to decide (ROADMAP queue C)",
    "SNTC_PEAK_FLOPS": "still to decide (ROADMAP queue C)",
    "SNTC_TREE_NODE_GROUP_MB": "still to decide (ROADMAP queue C)",
    "SNTC_TREE_SIBLING": "still to decide (ROADMAP queue C)",
    "SNTC_TREE_SIBLING_MB": "still to decide (ROADMAP queue C)",
    "SNTC_TREE_LABEL_FUSED": "still to decide (ROADMAP queue C)",
}
#: (constructor, parameter) whose default the port sets otherwise
DEFAULTS_DIFFER = {
    ("StreamingQuery", "overlap_sink"): "None keeps the port's rule: on "
                                        "when built with depth > 1",
}


def _script(name: str):
    """A JAX check script as a module, for its own patterns and maps."""
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_drift_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sources(root: str, skip=()):
    for dirpath, _dirs, files in os.walk(root):
        if "__pycache__" in dirpath:
            continue
        for name in sorted(files):
            path = os.path.join(dirpath, name)
            if name.endswith(".py") and os.path.relpath(path, root) \
                    not in skip:
                with open(path) as f:
                    yield os.path.relpath(path, REPO), f.read()


def _literals(pattern, root: str, skip=()) -> set:
    found = set()
    for _rel, text in _sources(root, skip):
        found.update(pattern.findall(text))
    return found


def _same(got, want) -> None:
    """Two name sets are equal: the assertion lists (missing, extra)."""
    got, want = set(got), set(want)
    assert (sorted(want - got), sorted(got - want)) == ([], [])


def _both(module: str, name: str):
    """(JAX, port) objects of one name."""
    return (getattr(importlib.import_module(f"sntc_tpu.{module}"), name),
            getattr(importlib.import_module(f"sntc_tpu_torch.{module}"),
                    name))


# ---------------------------------------------------------------------------
# fault sites (scripts/check_fault_sites.py)
# ---------------------------------------------------------------------------

FAULTS = os.path.join("resilience", "faults.py")


def _fault_site_literals(root: str) -> set:
    check = _script("check_fault_sites")
    return (_literals(check._CALL_RE, root, (FAULTS,))
            | _literals(check._DISK_RE, root, (FAULTS,)))


@pytest.mark.parametrize("case", ["called_sites_declared",
                                  "declared_sites_called",
                                  "sites_are_the_jax_sites",
                                  "kinds_are_the_jax_kinds"])
def test_fault_site_catalog(case):
    import sntc_tpu.resilience as J
    import sntc_tpu_torch.resilience as P

    called = _fault_site_literals(PORT)
    if case == "called_sites_declared":
        _same(set(P.SITES) | called, P.SITES)
    elif case == "declared_sites_called":
        _same(called & set(P.SITES), P.SITES)
    elif case == "sites_are_the_jax_sites":
        assert set(SITES_NOT_PORTED) <= set(J.SITES)
        _same(P.SITES, set(J.SITES) - set(SITES_NOT_PORTED))
        assert len(P.SITES) == len(set(P.SITES))
    else:
        assert P.ALL_KINDS == J.ALL_KINDS


# ---------------------------------------------------------------------------
# metric names (scripts/check_metric_names.py)
# ---------------------------------------------------------------------------

METRICS = os.path.join("obs", "metrics.py")


def _transfer_family() -> set:
    """The ``sntc_transfer_*`` names a tenant's ledger emits: the port
    builds them as ``f"sntc_transfer_{name}_total"``
    (``utils/profiling.py``), so they are read off a registry."""
    import sntc_tpu_torch.obs.metrics as m
    from sntc_tpu_torch.utils.profiling import TransferLedger

    prev = m.set_registry(m.MetricsRegistry())
    try:
        ledger = TransferLedger(tenant="t")
        ledger.record_uploads(1, 1)
        ledger.record_downloads(1, 1)
        ledger.record_movement(1, 1, 1, 1, 1)
        reg = m.registry()
        return {name for name in m.CATALOG
                if name.startswith("sntc_transfer_")
                and reg.get(name, tenant="t")}
    finally:
        m.set_registry(prev)


@pytest.mark.parametrize("case", ["code_names_declared",
                                  "declared_names_emitted",
                                  "catalog_is_the_jax_catalog"])
def test_metric_catalog(case):
    from sntc_tpu.obs.metrics import CATALOG as JCATALOG
    from sntc_tpu_torch.obs.metrics import CATALOG

    name_re = _script("check_metric_names")._NAME_RE
    emitted = _literals(name_re, PORT, (METRICS,))
    if case == "code_names_declared":
        with open(os.path.join(REPO, "chip_smoke.py")) as f:
            smoke = set(name_re.findall(f.read()))
        _same(set(CATALOG) | emitted | smoke, CATALOG)
    elif case == "declared_names_emitted":
        _same(set(CATALOG) & (emitted | _transfer_family()), CATALOG)
    else:
        assert set(METRICS_NOT_PORTED) <= set(JCATALOG)
        _same(CATALOG, set(JCATALOG) - set(METRICS_NOT_PORTED))


# ---------------------------------------------------------------------------
# span and event names
# ---------------------------------------------------------------------------

_SPAN_RE = re.compile(r"""\bspan\(\s*["']([A-Za-z0-9_.]+)["']""")
_EVENT_RE = re.compile(r"""\bevent\s*=\s*["']([A-Za-z0-9_.]+)["']""")


@pytest.mark.parametrize("kind", ["spans", "events"])
def test_span_and_event_names(kind):
    if kind == "spans":
        _same(_literals(_SPAN_RE, PORT), _literals(_SPAN_RE, JAX))
    else:
        jax, port = _literals(_EVENT_RE, JAX), _literals(_EVENT_RE, PORT)
        assert set(EVENTS_NOT_PORTED) <= jax
        _same(port, (jax - set(EVENTS_NOT_PORTED)) | set(EVENTS_PORT_ONLY))


# ---------------------------------------------------------------------------
# registries and constructors
# ---------------------------------------------------------------------------


def _fields(cls) -> list:
    return [f.name for f in dataclasses.fields(cls)]


#: registry -> its module (``ARTIFACTS`` is held by
#: ``test_torch_storage.py``, ``ALL_KINDS`` and ``MESH_AXES`` above and
#: below)
REGISTRIES = {"KNOB_NAMES": "data.pipeline",
              "SERVE_KNOB_NAMES": "serve.controller",
              "SLO_FIELDS": "serve.controller",
              "INGRESS_KEYS": "serve.tenancy", "TenantSpec": "serve.tenancy"}


@pytest.mark.parametrize("name", sorted(REGISTRIES))
def test_registries_are_the_jax_registries(name):
    jax, port = _both(REGISTRIES[name], name)
    if name == "TenantSpec":
        assert _fields(port) == _fields(jax)
    else:
        assert port == jax


#: constructor -> (module, parameters the port adds)
CONSTRUCTORS = {
    "FleetCoordinator": ("serve.fleet", ()),
    "ReplicationPlane": ("resilience.replicate", ()),
    "build_ingress": ("serve.ingress", ()),
    "DirStreamSource": ("serve.streaming", ()),
    "DriftMonitor": ("lifecycle", ()),
    "ServeController": ("serve.controller", ()),
    "StreamingQuery": ("serve.streaming", ("device",)),
    "LifecycleManager": ("lifecycle", ("device",)),
    "ModelPromoter": ("lifecycle", ("device",)),
    "FlowCaptureSource": ("flow", ()),
    "FlowFeatureEngine": ("flow", ()),
    "PcapFlowMeter": ("flow", ()),
}


def _params(fn) -> dict:
    return {k: p.default for k, p in inspect.signature(fn).parameters.items()}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructors_take_the_jax_parameters(name):
    module, added = CONSTRUCTORS[name]
    jax, port = (_params(f) for f in _both(module, name))
    _same(port, set(jax) | set(added))
    for key in jax:
        if (name, key) not in DEFAULTS_DIFFER:
            assert repr(port[key]) == repr(jax[key]), key


# ---------------------------------------------------------------------------
# the operator flags (scripts/check_*_flags.py)
# ---------------------------------------------------------------------------


def _port_commands() -> dict:
    from sntc_tpu_torch.app import build_parser

    return _commands(build_parser())


def _commands(parser) -> dict:
    """subcommand -> {option string: action}."""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {cmd: {opt: a for a in p._actions for opt in a.option_strings}
            for cmd, p in sub.choices.items()}


def _jax_commands(monkeypatch) -> dict:
    """The JAX command's parser, caught where its ``main`` parses."""
    import sntc_tpu.app as jax_app

    class Parsed(Exception):
        pass

    def capture(self, argv=None, namespace=None):
        raise Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Parsed) as caught:
        jax_app.main(["train"])
    monkeypatch.undo()
    return _commands(caught.value.args[0])


def _has(owner, target: str) -> bool:
    """``target`` is a keyword of ``owner``'s constructor or a method."""
    return target in inspect.signature(owner).parameters or callable(
        getattr(owner, target, None))


def _flags_controller(cmds):
    from sntc_tpu_torch.obs.metrics import CATALOG
    from sntc_tpu_torch.serve.controller import SLO_FIELDS
    from sntc_tpu_torch.serve.tenancy import TenantSpec

    check = _script("check_controller_flags")
    for flag in list(check.SLO_FLAGS.values()) + list(check.ARM_FLAGS):
        for cmd in ("serve", "serve-daemon"):
            assert flag in cmds[cmd], (cmd, flag)
    assert set(SLO_FIELDS) == set(check.SLO_FLAGS)
    assert set(SLO_FIELDS) <= set(_fields(TenantSpec))
    assert set(check.CTL_METRICS) <= set(CATALOG)


def _flags_ingest(cmds):
    from sntc_tpu_torch.data.pipeline import KNOB_NAMES
    from sntc_tpu_torch.obs.metrics import CATALOG
    from sntc_tpu_torch.serve.streaming import DirStreamSource, StreamingQuery

    check = _script("check_ingest_flags")
    for flag in check.KNOB_FLAGS.values():
        assert flag in cmds["serve"], flag
    for flag in check.ARM_FLAGS:
        for cmd in ("serve", "serve-daemon"):
            assert flag in cmds[cmd], (cmd, flag)
    assert set(KNOB_NAMES) == set(check.KNOB_FLAGS)
    for setter in ("set_read_workers", "set_prefetch_batches"):
        assert callable(getattr(DirStreamSource, setter, None)), setter
    assert "pipeline_depth" in inspect.signature(StreamingQuery).parameters
    assert set(check.INGEST_METRICS) <= set(CATALOG)


def _flags_ingress(cmds):
    from sntc_tpu_torch.obs.metrics import CATALOG
    from sntc_tpu_torch.serve.ingress import build_ingress
    from sntc_tpu_torch.serve.tenancy import INGRESS_KEYS

    check = _script("check_ingress_flags")
    params = set(inspect.signature(build_ingress).parameters)
    for knob, flag in check.FLAG_KNOBS.items():
        for cmd in ("serve", "serve-daemon"):
            assert flag in cmds[cmd], (cmd, flag)
        assert knob in params and knob in INGRESS_KEYS, knob
    assert set(INGRESS_KEYS) <= params
    assert {n for n in CATALOG if n.startswith("sntc_ingress_")} \
        == set(check.INGRESS_METRICS)


def _flags_repl(cmds):
    from sntc_tpu_torch.obs.metrics import CATALOG
    from sntc_tpu_torch.resilience.replicate import ReplicationPlane

    check = _script("check_repl_flags")
    params = set(inspect.signature(ReplicationPlane).parameters)
    for knob, flag in check.FLAG_KNOBS.items():
        for cmd in ("serve", "serve-daemon", "fleet-serve"):
            assert flag in cmds[cmd], (cmd, flag)
        assert knob in params, knob
    assert {n for n in CATALOG if n.startswith("sntc_repl_")} \
        == set(check.REPL_METRICS)


def _flags_fleet(cmds):
    from sntc_tpu_torch.serve.fleet import FleetCoordinator

    check = _script("check_fleet_flags")
    kwargs = set(inspect.signature(FleetCoordinator.__init__).parameters) \
        - check._CTOR_INTERNAL
    for flag, kwarg in check.FLAGS:
        assert flag in cmds["fleet-serve"], flag
        assert kwarg is None or kwarg in kwargs, (flag, kwarg)
    assert kwargs == {k for _f, k in check.FLAGS if k is not None}


def _flags_tenant(cmds):
    from sntc_tpu_torch.serve.tenancy import TenantSpec

    check = _script("check_tenant_flags")
    for flag, field in check.FLAGS:
        for cmd in ("serve-daemon", "fleet-serve"):
            assert flag in cmds[cmd], (cmd, flag)
        assert field in _fields(TenantSpec), (flag, field)


def _flags_lifecycle(cmds):
    import sntc_tpu_torch.lifecycle as lifecycle

    check = _script("check_lifecycle_flags")
    for flag, owner, target in check.FLAGS:
        assert flag in cmds["serve"], flag
        assert _has(getattr(lifecycle, owner), target), (flag, owner)


def _flags_flow(cmds):
    import sntc_tpu_torch.flow as flow
    from sntc_tpu_torch.serve.tenancy import TenantSpec

    check = _script("check_flow_flags")
    for flag, owner, target in check.FLAGS:
        assert flag in cmds["serve"], flag
        assert target in inspect.signature(getattr(flow, owner)).parameters
    assert "--from-capture" in cmds["serve-daemon"]
    assert {"from_capture", "flow_options"} <= set(_fields(TenantSpec))


def _flags_perf(cmds):
    import sntc_tpu_torch.serve.streaming as streaming

    check = _script("check_perf_flags")
    for flag, owner, kwarg in check.FLAGS:
        assert flag in cmds["serve"], flag
        assert kwarg in inspect.signature(getattr(streaming, owner)).parameters
    for owner, kwarg in check.ENGINE_ONLY_KWARGS:
        assert kwarg in inspect.signature(getattr(streaming, owner)).parameters


FLAG_CHECKS = {
    "controller": _flags_controller, "ingest": _flags_ingest,
    "ingress": _flags_ingress, "repl": _flags_repl, "fleet": _flags_fleet,
    "tenant": _flags_tenant, "lifecycle": _flags_lifecycle,
    "flow": _flags_flow, "perf": _flags_perf,
}


@pytest.mark.parametrize("name", sorted(FLAG_CHECKS))
def test_operator_flags_map_to_the_port(name):
    """``scripts/check_<name>_flags.py``'s map, held on the port's
    parser and the port's counterparts."""
    FLAG_CHECKS[name](_port_commands())


JAX_COMMANDS = ["evaluate", "fleet-restore-retired", "fleet-serve", "fsck",
                "serve", "serve-daemon", "synth", "train"]
FLAG_ATTRS = ("dest", "default", "choices", "nargs", "const", "required",
              "type")


@pytest.mark.parametrize("cmd", JAX_COMMANDS)
def test_command_flags_are_the_jax_commands(cmd, monkeypatch):
    jax = _jax_commands(monkeypatch)
    port = _port_commands()
    assert sorted(port) == sorted(jax) == JAX_COMMANDS
    want = {FLAGS_RENAMED.get(o, o) for o in jax[cmd]
            if (cmd, o) not in FLAGS_NOT_PORTED}
    _same(port[cmd], want)
    for opt, j in jax[cmd].items():
        if (cmd, opt) in FLAGS_NOT_PORTED or opt in FLAGS_RENAMED:
            continue
        p = port[cmd][opt]
        assert type(p) is type(j), opt
        for attr in FLAG_ATTRS:
            if (cmd, opt, attr) not in FLAG_ATTRS_DIFFER:
                assert getattr(p, attr) == getattr(j, attr), (opt, attr)


# ---------------------------------------------------------------------------
# fusible stages (scripts/check_fusible_stages.py)
# ---------------------------------------------------------------------------


def test_fusible_stages_are_the_jax_stages():
    import sntc_tpu.feature as jax_feature
    import sntc_tpu_torch.feature as feature
    from sntc_tpu.fuse import registered_types
    from sntc_tpu_torch.core.base import Estimator, Transformer
    from sntc_tpu_torch.fuse.registry import _REGISTRY

    jax_fused = {cls.__name__ for cls in registered_types()}
    stages = [n for n in feature.__all__
              if isinstance(cls := getattr(feature, n), type)
              and issubclass(cls, Transformer)
              and not issubclass(cls, Estimator)]
    assert set(stages) >= jax_fused
    for name in stages:
        assert (getattr(feature, name) in _REGISTRY) == (
            name in jax_fused and hasattr(jax_feature, name)), name
    assert len(jax_fused) == 15


# ---------------------------------------------------------------------------
# the kernel registry (scripts/check_kernel_registry.py)
# ---------------------------------------------------------------------------

CSRC = os.path.join(PORT, "kernels", "csrc")
_ENTRY_RE = re.compile(r'extern "C" int (sntc_\w+)\(')
_LAUNCH_RE = re.compile(r'LAUNCHES\["(\w+)"\] \+= 1')


def _launching_wrappers() -> dict:
    """kernel name -> (module path, the function that counts its
    launches), from the ``LAUNCHES[...] += 1`` statements."""
    found = {}
    for rel, text in _sources(os.path.join(PORT, "kernels")):
        tree = ast.parse(text)
        for fn in ast.walk(tree):
            if isinstance(fn, ast.FunctionDef):
                for key in _LAUNCH_RE.findall(ast.get_source_segment(text,
                                                                     fn)):
                    found[key] = (rel, fn.name)
    return found


def _cuda_marked_calls() -> set:
    """Names called in the test functions marked ``cuda``."""
    called = set()
    for _rel, text in _sources(os.path.join(REPO, "tests")):
        if not os.path.basename(_rel).startswith("test_torch_"):
            continue
        marked_module = re.search(r"^pytestmark\b.*mark\.cuda", text,
                                  re.MULTILINE) is not None
        for fn in ast.walk(ast.parse(text)):
            if not isinstance(fn, ast.FunctionDef):
                continue
            marks = " ".join(ast.unparse(d) for d in fn.decorator_list)
            if marked_module or "mark.cuda" in marks:
                for node in ast.walk(fn):
                    if isinstance(node, ast.Call):
                        f = node.func
                        called.add(f.id if isinstance(f, ast.Name)
                                   else getattr(f, "attr", None))
    return called


@pytest.mark.parametrize("case", ["sources_built", "entry_points_bound",
                                  "launches_have_their_parts",
                                  "pallas_kernels_in_perf_table"])
def test_kernel_registry(case):
    from sntc_tpu_torch.kernels import _build

    if case == "sources_built":
        _same((f for f in os.listdir(CSRC) if f.endswith(".cu")),
              _build.SOURCES)
    elif case == "entry_points_bound":
        entries = set()
        for name in _build.SOURCES:
            with open(os.path.join(CSRC, name)) as f:
                entries.update(_ENTRY_RE.findall(f.read()))
        _same(entries, _build._SIGNATURES)
    elif case == "launches_have_their_parts":
        wrappers = _launching_wrappers()
        _same(wrappers, _build.LAUNCHES)
        cuda_calls = _cuda_marked_calls()
        with open(os.path.join(REPO, "chip_smoke.py")) as f:
            smoke = set(re.findall(r'"name": "(\w+)", "route"', f.read()))
        for key, (rel, fn) in wrappers.items():
            assert fn.endswith("_cuda"), (key, fn)
            mod = importlib.import_module(
                rel[:-3].replace(os.sep, "."))
            assert callable(getattr(mod, fn[:-5] + "_reference", None)), key
            assert fn in cuda_calls, (key, fn)
            assert key in smoke, key
    else:
        pallas = _script("check_kernel_registry")._pallas_modules()
        assert len(pallas) == 3
        with open(os.path.join(REPO, "PERF.md")) as f:
            rows = [line for line in f if line.startswith("| `")]
        for mod in pallas:
            assert any(f"`{mod}:" in row for row in rows), mod


# ---------------------------------------------------------------------------
# mesh axes (scripts/check_mesh_axes.py) and the collective substrate
# ---------------------------------------------------------------------------

_DIST_RE = re.compile(r"\btorch\.distributed\b|from torch import distributed")


@pytest.mark.parametrize("case", ["axes_are_the_jax_axes",
                                  "distributed_only_in_parallel"])
def test_mesh_substrate(case):
    if case == "axes_are_the_jax_axes":
        jax, port = _both("parallel.mesh", "MESH_AXES")
        assert port == jax
        import sntc_tpu_torch.parallel.mesh as mesh

        assert {mesh.DATA_AXIS, mesh.MODEL_AXIS} == set(port)
    else:
        outside = [rel for rel, text in _sources(PORT)
                   if not rel.startswith(os.path.join("sntc_tpu_torch",
                                                      "parallel"))
                   and _DIST_RE.search(text)]
        assert outside == []


# ---------------------------------------------------------------------------
# the environment switches
# ---------------------------------------------------------------------------

_ENV_RE = re.compile(r"""["'](SNTC_[A-Z0-9_]+)["']""")


def test_environment_switches_are_the_jax_switches():
    jax, port = _literals(_ENV_RE, JAX), _literals(_ENV_RE, PORT)
    assert set(ENV_NOT_READ) <= jax
    _same(port, jax - set(ENV_NOT_READ))
