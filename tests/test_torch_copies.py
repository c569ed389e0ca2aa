"""Copy fidelity: each framework-free module the port copies from the JAX
package equals its original. A verbatim copy equals it line for line, apart
from the copy's first-line origin note and `repro.` -> `repro_torch.` in
import statements (and, in `configs/__init__.py`, in the one module string
it imports by name). A copy whose docstrings or import wrapping were
adapted equals it in code: the same AST once docstrings are dropped and
`repro_torch` modules are named `repro` again. An edit to one side without
the other fails here instead of drifting silently. The plane's adapted
modules are held the same way outside what they change: `plane/lb.py`
outside its one repaired statement, `plane/host.py` and
`plane/replica.py` definition by definition outside the definitions the
torch backend changes."""
from __future__ import annotations

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = [
    "configs/base.py", "configs/chameleon_34b.py", "configs/deepseek_7b.py",
    "configs/granite_moe_1b_a400m.py", "configs/granite_moe_3b_a800m.py",
    "configs/llama31_8b.py", "configs/mamba2_780m.py",
    "configs/minitron_4b.py", "configs/qwen3_0_6b.py",
    "configs/starcoder2_7b.py", "configs/whisper_medium.py",
    "configs/zamba2_7b.py",
]
COPIES = [
    "routing/__init__.py", "routing/build.py", "routing/core.py",
    "routing/failover.py", "routing/hashring.py", "routing/hedging.py",
    "routing/kvtransfer.py", "routing/policies.py", "routing/prefixtree.py",
    "tenancy/__init__.py", "tenancy/admission.py", "tenancy/discipline.py",
    "tenancy/ledger.py", "replica/blocks.py", "replica/hostpool.py",
    "replica/radix.py", "serving/request.py", "serving/bucketing.py",
    *CONFIGS, "configs/__init__.py",
    "frontend/__init__.py", "frontend/api.py", "frontend/client.py",
    "core/__init__.py", "core/metrics.py", "core/workloads.py",
    "core/simulator.py", "core/system.py", "replica/backends.py",
    "plane/wire.py", "plane/chaos.py", "plane/mailbox.py",
    "plane/transport.py", "plane/metrics.py",
]
IMPORT = re.compile(r"^(\s*)(from|import) repro\.")
# besides imports, the only line a verbatim copy may change: original line
# number -> (original text, the copy's text)
RENAMED = {
    "configs/__init__.py": {37: (
        '    mod = importlib.import_module(f"repro.configs.'
        '{_ARCH_MODULES[key]}")',
        '    mod = importlib.import_module(f"repro_torch.configs.'
        '{_ARCH_MODULES[key]}")')},
}
SAME_CODE = ["replica/core.py", "serving/router.py", "replica/__init__.py",
             "plane/__init__.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_original(rel):
    orig = (ROOT / "src" / "repro" / rel).read_text().splitlines()
    copy = (ROOT / "src" / "repro_torch" / rel).read_text().splitlines()
    assert copy[0] == f"# Copy of src/repro/{rel} (no import of the JAX " \
                      f"package)."
    want = [IMPORT.sub(r"\1\2 repro_torch.", line) for line in orig]
    for lineno, (was, now) in RENAMED.get(rel, {}).items():
        assert orig[lineno - 1] == was, f"{rel}:{lineno} moved in the original"
        want[lineno - 1] = now
    assert len(copy) - 1 == len(want)
    for i, (got, exp) in enumerate(zip(copy[1:], want), start=1):
        assert got == exp, f"{rel}:{i + 1}: {got!r} != original {exp!r}"


def _code(path: Path, package: str) -> str:
    """The module's AST without docstrings, with `package` module names in
    import statements spelled `repro`."""
    return ast.dump(_stripped(path, package))


def _stripped(path: Path, package: str) -> ast.Module:
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
        elif isinstance(node, ast.Import):
            for alias in node.names:
                alias.name = re.sub(rf"^{package}(?=\.|$)", "repro",
                                    alias.name)
        elif isinstance(node, ast.ImportFrom) and node.module:
            node.module = re.sub(rf"^{package}(?=\.|$)", "repro", node.module)
    return tree


@pytest.mark.parametrize("rel", SAME_CODE)
def test_copy_has_the_originals_code(rel):
    copy = ROOT / "src" / "repro_torch" / rel
    assert copy.read_text().startswith(f"# Copy of src/repro/{rel} ")
    assert _code(copy, "repro_torch") == \
        _code(ROOT / "src" / "repro" / rel, "repro")


# plane/lb.py: the one statement the port repairs (and the import it
# needs), and the reference's statement in its place
LB_REPAIR = (
    """        # `ServingPlane.start` ships the spec through `dataclasses.asdict`,
        # which turns a `KVTransferParams` override into a plain dict:
        # rebuild it, or the first KV decision reads a dict's attributes
        cfg = rspec.make_config(**{
            k: (KVTransferParams(**v)
                if k == "kv_params" and isinstance(v, dict) else v)
            for k, v in dict(spec.cfg_overrides).items()})
""",
    "        cfg = rspec.make_config(**dict(spec.cfg_overrides))\n")
LB_IMPORT = "from repro_torch.routing.kvtransfer import KVTransferParams\n"


def test_plane_lb_is_the_original_outside_its_repair(tmp_path):
    text = (ROOT / "src" / "repro_torch" / "plane" / "lb.py").read_text()
    assert text.startswith("# Copy of src/repro/plane/lb.py ")
    assert text.count(LB_REPAIR[0]) == 1 and text.count(LB_IMPORT) == 1
    undone = tmp_path / "lb.py"
    undone.write_text(text.replace(LB_REPAIR[0], LB_REPAIR[1])
                      .replace(LB_IMPORT, ""))
    assert _code(undone, "repro_torch") == \
        _code(ROOT / "src" / "repro" / "plane" / "lb.py", "repro")


def _defs(path: Path, package: str) -> dict:
    """Each top-level definition and method of the module, by qualified
    name, as `_code` dumps it (no docstrings, imports spelled `repro`)."""
    out = {}
    for node in _stripped(path, package).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.dump(node)
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef):
                    out[f"{node.name}.{sub.name}"] = ast.dump(sub)
    return out


# what the torch backend changes in each adapted plane module; every
# other definition equals the original's
PLANE_CHANGED = {
    "plane/host.py": {"PlaneConfig", "ServingPlane", "ServingPlane.start"},
    "plane/replica.py": {
        "ReplicaSpec", "_build_engine", "_ReplicaServer",
        "_ReplicaServer.__init__", "_ReplicaServer.handle",
        "_ReplicaServer._import_kv", "_ReplicaServer._check_kv",
        "_ReplicaServer.snapshot", "_ReplicaServer._heartbeat",
        "_encode_kv", "_decode_kv_arrays", "_kv_bytes", "_kernel_launches",
        "replica_main"},
}


@pytest.mark.parametrize("rel", sorted(PLANE_CHANGED))
def test_plane_module_keeps_the_originals_definitions(rel):
    copy = _defs(ROOT / "src" / "repro_torch" / rel, "repro_torch")
    orig = _defs(ROOT / "src" / "repro" / rel, "repro")
    changed = PLANE_CHANGED[rel]
    assert set(copy) - set(orig) <= changed
    kept = set(orig) - changed
    assert kept <= set(copy), f"{rel} lost {sorted(kept - set(copy))}"
    for name in sorted(kept):
        assert copy[name] == orig[name], f"{rel}: {name} differs"
