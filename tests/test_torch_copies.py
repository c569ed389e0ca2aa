"""Copy fidelity: each framework-free module the port copies from the JAX
package equals its original. A verbatim copy equals it line for line, apart
from the copy's first-line origin note and `repro.` -> `repro_torch.` in
import statements (and, in `configs/__init__.py`, in the one module string
it imports by name). A copy whose docstrings or import wrapping were
adapted equals it in code: the same AST once docstrings are dropped and
`repro_torch` modules are named `repro` again. An edit to one side without
the other fails here instead of drifting silently."""
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
SAME_CODE = ["replica/core.py", "serving/router.py", "replica/__init__.py"]


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
    return ast.dump(tree)


@pytest.mark.parametrize("rel", SAME_CODE)
def test_copy_has_the_originals_code(rel):
    copy = ROOT / "src" / "repro_torch" / rel
    assert copy.read_text().startswith(f"# Copy of src/repro/{rel} ")
    assert _code(copy, "repro_torch") == \
        _code(ROOT / "src" / "repro" / rel, "repro")
