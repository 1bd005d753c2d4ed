"""The port's surface, checked against the JAX package's.

Every module of hifimeth_tpu/ is read with ast (nothing is imported, so jax
is not needed): each top-level public function and class, and each public
method of its classes, must have a same-named counterpart in the same-path
module of hifimeth_tpu_torch/, also read with ast, or an entry in EXEMPT
below.  An entry names the port's counterpart (checked to exist) or gives
a reason; a reason alone may not cover a name that a module of the JAX
package calls.  Every field of every dataclass of the JAX package must be
a field of the same-named dataclass in the same-path module of the port,
or an entry in FIELD_EXEMPT; the port's CallConfig takes every field and
default of the JAX one.  The two CLIs must take the same subcommands and,
for each, the same options, apart from the port's --device.
"""
import ast
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "hifimeth_tpu")
PORT_PKG = os.path.join(ROOT, "hifimeth_tpu_torch")

#: "module:name" of the JAX package -> (the port's counterpart as
#: "module:name", or None, and the reason)
EXEMPT = {
    "model/cnn.py:dnamodnet_apply": (
        "model/cnn.py:DNAModNet", "the forward pass is the module's"),
    "ops/fused.py:reverse_table": (
        "ops/fused.py:fused_forward",
        "the fused kernel takes `rev` and reads the forward table "
        "(ROADMAP C, fused reverse strand)"),
    "engine/call.py:enable_compilation_cache": (
        "ops/build.py:kernel_library",
        "XLA's compile cache; the port's kernels build once into _build/"),
    "features/windows.py:call_sites_pallas": (
        "features/windows.py:call_sites_group", "the pallas path's call"),
    "features/windows.py:call_sites_pallas_dp": (
        "engine/call.py:CallEngine",
        "the engine splits each batch over its device list"),
    "parallel/collectives.py:psum_histograms": (
        "parallel/collectives.py:psum_histograms_multihost",
        "one all-reduce over the torch.distributed group"),
    "parallel/mesh.py:make_mesh": (
        "parallel/mesh.py:TrainLayout", "torchrun ranks replace the mesh"),
    "parallel/mesh.py:batch_sharding": (
        "parallel/mesh.py:TrainLayout", "contiguous batch slices per rank"),
    "parallel/mesh.py:replicated": (
        "parallel/mesh.py:resolve_devices",
        "the engine's device list holds a model set per device"),
    "parallel/mesh.py:shard_tree": (
        "parallel/mesh.py:shard_state_dict", "each rank keeps its slice"),
    "parallel/mesh.py:train_param_shardings": (
        "parallel/mesh.py:TrainLayout", "FC1 columns and FC2 rows per rank"),
    "parallel/mesh.py:infer_param_shardings": (
        None, "no module of the JAX package calls it (ROADMAP C)"),
    "train/model.py:apply_train": (
        "train/model.py:TrainNet", "the train-mode forward is the module's"),
    "train/trainer.py:make_optimizer": (
        "train/trainer.py:TrainStep", "SGD, Nesterov, StepLR in the step"),
    "train/trainer.py:make_train_step": (
        "train/trainer.py:TrainStep", "one object per training run"),
    "tools/import_model.py:main": (
        "cli.py:_model_command", "the port's CLI parses every subcommand"),
    "tools/extract_features.py:main": (
        "cli.py:_model_command", "the port's CLI parses every subcommand"),
}


def _modules(pkg):
    out = []
    for d, dirs, files in os.walk(pkg):
        dirs[:] = sorted(x for x in dirs if not x.startswith(("_", ".")))
        out += [os.path.relpath(os.path.join(d, f), pkg)
                for f in sorted(files) if f.endswith(".py")]
    return out


def _public(path) -> set:
    """Top-level public functions and classes, and Class.method for the
    public methods of each class."""
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and not node.name.startswith("_"):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names |= {f"{node.name}.{m.name}" for m in node.body
                          if isinstance(m, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))
                          and not m.name.startswith("_")}
    return names


def _defined(pkg, module) -> set:
    """Every function and class name defined anywhere in a port module,
    private ones too (an exemption may name one)."""
    path = os.path.join(pkg, module)
    if not os.path.exists(path):
        return set()
    return {n.name for n in ast.walk(ast.parse(open(path).read()))
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


def _jax_surface():
    return sorted(f"{m}:{name}" for m in _modules(JAX_PKG)
                  for name in _public(os.path.join(JAX_PKG, m)))


JAX_SURFACE = _jax_surface()


def _called_in_jax(name: str) -> bool:
    """A call of `name` (as f(...) or x.f(...)) in any JAX module."""
    for m in _modules(JAX_PKG):
        for n in ast.walk(ast.parse(open(os.path.join(JAX_PKG, m)).read())):
            if isinstance(n, ast.Call):
                f = n.func
                if (isinstance(f, ast.Name) and f.id == name) or \
                        (isinstance(f, ast.Attribute) and f.attr == name):
                    return True
    return False


def test_surface_is_read():
    assert len(JAX_SURFACE) > 200
    assert "engine/call.py:ModelSet.cached" in JAX_SURFACE


@pytest.mark.parametrize("entry", JAX_SURFACE)
def test_port_has_counterpart(entry):
    module, name = entry.split(":")
    port = os.path.join(PORT_PKG, module)
    if os.path.exists(port) and name in _public(port):
        assert entry not in EXEMPT, f"{entry} is ported: drop its exemption"
        return
    assert entry in EXEMPT, (f"{entry} has no counterpart in "
                             f"hifimeth_tpu_torch/{module}")


@pytest.mark.parametrize("entry", sorted(EXEMPT))
def test_exemption_is_sound(entry):
    counterpart, reason = EXEMPT[entry]
    assert entry in JAX_SURFACE and reason
    if counterpart is None:
        assert not _called_in_jax(entry.split(":")[1].split(".")[-1]), (
            f"{entry} is called by the JAX package: port it")
        return
    module, name = counterpart.split(":")
    assert name in _defined(PORT_PKG, module), counterpart


# -- dataclass fields --------------------------------------------------------

#: "module:Class.field" of the JAX package -> why the port has no such field
#: (none today: each entry must name a field the port lacks)
FIELD_EXEMPT: dict = {}


def _is_dataclass(node) -> bool:
    for d in node.decorator_list:
        f = d.func if isinstance(d, ast.Call) else d
        if (isinstance(f, ast.Name) and f.id == "dataclass") or \
                (isinstance(f, ast.Attribute) and f.attr == "dataclass"):
            return True
    return False


def _dataclass_fields(pkg, module) -> dict:
    """Class name -> its field names, for each top-level dataclass of a
    module (annotated names of the class body, ClassVar ones left out)."""
    path = os.path.join(pkg, module)
    if not os.path.exists(path):
        return {}
    out = {}
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.ClassDef) and _is_dataclass(node):
            out[node.name] = [
                st.target.id for st in node.body
                if isinstance(st, ast.AnnAssign)
                and isinstance(st.target, ast.Name)
                and "ClassVar" not in ast.unparse(st.annotation)]
    return out


JAX_FIELDS = sorted(f"{m}:{cls}.{name}" for m in _modules(JAX_PKG)
                    for cls, names in _dataclass_fields(JAX_PKG, m).items()
                    for name in names)


def test_fields_are_read():
    assert len(JAX_FIELDS) > 80
    assert "engine/call.py:CallConfig.conv_impl" in JAX_FIELDS
    assert "engine/call.py:CallConfig.feat_channels" in JAX_FIELDS
    for entry in FIELD_EXEMPT:
        assert entry in JAX_FIELDS and FIELD_EXEMPT[entry], entry


@pytest.mark.parametrize("entry", JAX_FIELDS)
def test_port_dataclass_has_field(entry):
    module, qual = entry.split(":")
    cls, name = qual.split(".")
    port = _dataclass_fields(PORT_PKG, module)
    assert cls in port, f"hifimeth_tpu_torch/{module} has no dataclass {cls}"
    if name in port[cls]:
        assert entry not in FIELD_EXEMPT, f"{entry} is ported: drop it"
        return
    assert entry in FIELD_EXEMPT, (f"{entry} has no field in "
                                   f"hifimeth_tpu_torch/{module}")


def test_call_config_takes_every_jax_field_and_default():
    """The port's CallConfig built from every field name and default of the
    JAX one (a JAX library caller's configuration) keeps those values and
    builds an engine on the CPU."""
    import dataclasses

    from hifimeth_tpu.engine.call import CallConfig as JaxCallConfig
    from hifimeth_tpu_torch.engine.call import CallConfig, CallEngine
    jax_cfg = JaxCallConfig()
    values = {f.name: getattr(jax_cfg, f.name)
              for f in dataclasses.fields(JaxCallConfig)}
    cfg = CallConfig(**values, device="cpu")
    for name, value in values.items():
        assert getattr(cfg, name) == value, name
    eng = CallEngine(dataclasses.replace(cfg, contexts=("CpG",)))
    assert eng.cfg.conv_impl == jax_cfg.conv_impl
    assert eng.cfg.feat_channels == jax_cfg.feat_channels


# -- the CLIs ----------------------------------------------------------------

OPTION = re.compile(r"^--?[A-Za-z][\w-]*$")
#: both CLIs answer -h with the usage text: the port's option parser by the
#: flag, the JAX one by its positional count, so the flag is not compared
HELP = {"-h", "--help"}


def _options(nodes, funcs, path, seen) -> set:
    """Option strings in `nodes`, following calls of the module's own
    functions and `from .x import main` into module x."""
    out = set()
    for stmt in nodes:
        for n in ast.walk(stmt):
            if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                    and OPTION.match(n.value):
                out.add(n.value)
            elif isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                    and n.func.id in funcs and n.func.id not in seen:
                seen.add(n.func.id)
                out |= _options(funcs[n.func.id].body, funcs, path, seen)
            elif isinstance(n, ast.ImportFrom) and n.level and \
                    any(a.name == "main" for a in n.names):
                d = os.path.dirname(path)
                for _ in range(n.level - 1):
                    d = os.path.dirname(d)
                f = os.path.join(d, *n.module.split(".")) + ".py"
                if f not in seen:
                    seen.add(f)
                    tree = ast.parse(open(f).read())
                    out |= _options(tree.body, {
                        x.name: x for x in tree.body
                        if isinstance(x, ast.FunctionDef)}, f, seen)
    return out


def _cli(pkg) -> dict:
    """subcommand -> its options, from the `cmd == "name"` branches."""
    path = os.path.join(pkg, "cli.py")
    tree = ast.parse(open(path).read())
    funcs = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}
    subs = {}
    for n in ast.walk(tree):
        if isinstance(n, ast.If) and isinstance(n.test, ast.Compare) and \
                isinstance(n.test.left, ast.Name) and \
                n.test.left.id == "cmd" and isinstance(n.test.ops[0], ast.Eq):
            subs[n.test.comparators[0].value] = \
                _options(n.body, funcs, path, set()) - HELP
    return subs


JAX_CLI = _cli(JAX_PKG)


def test_cli_subcommands_equal():
    assert len(JAX_CLI) >= 13
    assert sorted(_cli(PORT_PKG)) == sorted(JAX_CLI)


@pytest.mark.parametrize("cmd", sorted(JAX_CLI))
def test_cli_options_equal_but_device(cmd):
    port = _cli(PORT_PKG)[cmd]
    assert port - {"--device"} == JAX_CLI[cmd]
    if cmd == "call":
        assert {"--gather-impl", "--shard", "--sync-emit"} <= port
