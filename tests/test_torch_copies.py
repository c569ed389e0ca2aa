"""Copy fidelity: each framework-free module the port copies from the JAX
package equals its original line for line, apart from the copy's first-line
origin note and `repro.` -> `repro_torch.` in import statements. An edit to
one side without the other fails here instead of drifting silently."""
from __future__ import annotations

import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
COPIES = [
    "routing/__init__.py", "routing/build.py", "routing/core.py",
    "routing/failover.py", "routing/hashring.py", "routing/hedging.py",
    "routing/kvtransfer.py", "routing/policies.py", "routing/prefixtree.py",
    "tenancy/__init__.py", "tenancy/admission.py", "tenancy/discipline.py",
    "tenancy/ledger.py", "replica/blocks.py", "replica/hostpool.py",
    "replica/radix.py", "serving/request.py", "serving/bucketing.py",
]
IMPORT = re.compile(r"^(\s*)(from|import) repro\.")


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_original(rel):
    orig = (ROOT / "src" / "repro" / rel).read_text().splitlines()
    copy = (ROOT / "src" / "repro_torch" / rel).read_text().splitlines()
    assert copy[0] == f"# Copy of src/repro/{rel} (no import of the JAX " \
                      f"package)."
    want = [IMPORT.sub(r"\1\2 repro_torch.", line) for line in orig]
    assert len(copy) - 1 == len(want)
    for i, (got, exp) in enumerate(zip(copy[1:], want), start=1):
        assert got == exp, f"{rel}:{i + 1}: {got!r} != original {exp!r}"
