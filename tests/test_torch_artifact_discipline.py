"""The artifact-writer rule on the port: inside ``atomo_tpu_torch/`` every
train_dir artifact goes through ``utils.tracing.write_json_atomic`` or the
append-only line writers (the incident log, the flight recorder), so a bare
``json.dump`` anywhere else in the package is a violation.

The rule is the JAX package's own (``scripts/check_artifact_discipline.py``,
loaded through ``importlib`` and used as it is): its AST test of a
``json.dump(...)`` call, applied to the port's files with the port's one
allowed writer.
"""

import ast
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ALLOWED = {Path("atomo_tpu_torch") / "utils" / "tracing.py"}


def _rule():
    spec = importlib.util.spec_from_file_location(
        "check_artifact_discipline", ROOT / "scripts" / "check_artifact_discipline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bypasses(root: Path) -> list:
    rule = _rule()
    out = []
    for path in sorted((root / "atomo_tpu_torch").rglob("*.py")):
        rel = path.relative_to(root)
        if rel in ALLOWED:
            continue
        for node in ast.walk(ast.parse(path.read_text(), filename=str(rel))):
            if isinstance(node, ast.Call) and rule._is_json_dump(node):
                out.append(f"{rel}:{node.lineno}")
    return out


def test_no_bare_json_dump_in_the_port():
    assert not _bypasses(ROOT)
    # the one writer the rule allows is where the rule expects it
    assert "json.dump(" in (ROOT / "atomo_tpu_torch" / "utils" / "tracing.py").read_text()


@pytest.mark.parametrize("where", ["obs/rogue.py", "utils/tracing_helpers.py"])
def test_the_rule_fires_on_a_port_bypass(tmp_path, where):
    bad = tmp_path / "atomo_tpu_torch" / where
    bad.parent.mkdir(parents=True)
    bad.write_text("import json\n\n\ndef w(train_dir, obj):\n"
                   "    with open(train_dir + '/x.json', 'w') as f:\n"
                   "        json.dump(obj, f)\n")
    assert _bypasses(tmp_path) == [f"atomo_tpu_torch/{where}:6"]
