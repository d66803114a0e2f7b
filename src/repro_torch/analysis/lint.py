"""The port's own lint: the rules of ``repro.analysis.lint`` that apply to
torch code, so the gate runs where there is no JAX.

* ``no-bare-assert`` — input validation by ``assert`` vanishes under
  ``python -O``: raise ``ValueError`` / ``TypeError``, or tag a genuinely
  internal invariant ``# lint: allow-assert``. Tests are exempt.
* ``validation-survives-O`` — a ``raise`` behind ``if __debug__:``, or an
  ``assert`` whose message builds an exception that is never raised.
* ``no-legacy-names`` — the deprecated pre-``SparseSpec`` names of the
  JAX package (``sparse_linear_*``, ``incrs_linear_*``, ``bsr_matmul``,
  ...), and the ``ops.incrs_spmm`` attribute spelling.

(``pytree-static-meta`` concerns JAX pytrees and has no torch
counterpart.) ``lint_tree`` lints ``src/repro_torch`` with every rule and
the port's tests and examples with ``no-legacy-names`` only, as JAX's
lints ``src`` and its auxiliary trees.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, List, Optional, Sequence

ALLOW_ASSERT_TAG = "lint: allow-assert"

RULE_ASSERT = "no-bare-assert"
RULE_SURVIVES_O = "validation-survives-O"
RULE_LEGACY = "no-legacy-names"

ALL_RULES = (RULE_ASSERT, RULE_SURVIVES_O, RULE_LEGACY)

RULE_DESCRIPTIONS: Dict[str, str] = {
    RULE_ASSERT: "input validation must raise, not assert "
                 "(asserts vanish under python -O); tag internal "
                 f"invariants with `# {ALLOW_ASSERT_TAG}`",
    RULE_SURVIVES_O: "validation must not hide behind __debug__ or an "
                     "exception-constructing assert message",
    RULE_LEGACY: "deprecated pre-SparseSpec names only in shim "
                 "definition/re-export sites and tests/test_api.py",
}

LEGACY_NAMES = frozenset({
    "sparse_linear_init", "sparse_linear_from_mask", "sparse_linear_apply",
    "incrs_linear_init", "incrs_linear_from_dense",
    "incrs_linear_stack_init", "incrs_linear_apply",
    "incrs_linear_from_dense_sharded", "incrs_linear_sharded_init",
    "incrs_linear_shard", "incrs_linear_sharded_apply",
    "bsr_matmul", "index_match_matmul", "incrs_spmm_sharded",
})
# ``incrs_spmm`` is also a live kernel entry point: only the
# ``ops.incrs_spmm`` spelling is legacy.
LEGACY_OPS_ATTRS = frozenset({"incrs_spmm"}) | LEGACY_NAMES


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.message}"


def _terminal_name(node: ast.expr) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _has_allow_tag(lines: Sequence[str], lineno: int) -> bool:
    """The tag may sit on the assert's own line or the line above."""
    return any(1 <= ln <= len(lines) and ALLOW_ASSERT_TAG in lines[ln - 1]
               for ln in (lineno, lineno - 1))


def _rule_no_bare_assert(tree, path, lines) -> List[Finding]:
    return [Finding(path, node.lineno, RULE_ASSERT,
                    "bare `assert` is stripped under python -O; raise "
                    "ValueError/TypeError for input validation or tag an "
                    f"internal invariant with `# {ALLOW_ASSERT_TAG}`")
            for node in ast.walk(tree)
            if isinstance(node, ast.Assert)
            and not _has_allow_tag(lines, node.lineno)]


def _rule_validation_survives_o(tree, path, lines) -> List[Finding]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.If):
            test = node.test
            neg = isinstance(test, ast.UnaryOp) and \
                isinstance(test.op, ast.Not)
            name = test.operand if neg else test
            if isinstance(name, ast.Name) and name.id == "__debug__":
                body = node.orelse if neg else node.body
                if any(isinstance(n, ast.Raise)
                       for stmt in body for n in ast.walk(stmt)):
                    out.append(Finding(
                        path, node.lineno, RULE_SURVIVES_O,
                        "validation raise gated on __debug__ is stripped "
                        "under python -O; raise unconditionally"))
        elif isinstance(node, ast.Assert) and \
                isinstance(node.msg, ast.Call):
            fname = _terminal_name(node.msg.func) or ""
            if fname.endswith(("Error", "Exception", "Warning")):
                out.append(Finding(
                    path, node.lineno, RULE_SURVIVES_O,
                    f"assert message constructs {fname} but the whole "
                    f"statement vanishes under python -O; raise it "
                    f"instead"))
    return out


def _rule_no_legacy_names(tree, path, lines) -> List[Finding]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and node.id in LEGACY_NAMES \
                and isinstance(node.ctx, ast.Load):
            out.append(Finding(
                path, node.lineno, RULE_LEGACY,
                f"`{node.id}` is a one-release deprecation shim; use the "
                f"SparseSpec/plan/Linear surface"))
        elif isinstance(node, ast.Attribute) \
                and isinstance(node.ctx, ast.Load) \
                and (node.attr in LEGACY_NAMES
                     or (node.attr in LEGACY_OPS_ATTRS
                         and isinstance(node.value, ast.Name)
                         and node.value.id == "ops")):
            out.append(Finding(
                path, node.lineno, RULE_LEGACY,
                f"`.{node.attr}` is a one-release deprecation shim; use "
                f"ops.spmm / the plan surface"))
        elif isinstance(node, ast.ImportFrom):
            for alias in node.names:
                if alias.name in LEGACY_NAMES:
                    out.append(Finding(
                        path, node.lineno, RULE_LEGACY,
                        f"importing deprecated `{alias.name}`; use the "
                        f"SparseSpec/plan/Linear surface"))
    return out


_RULE_FNS = {RULE_ASSERT: _rule_no_bare_assert,
             RULE_SURVIVES_O: _rule_validation_survives_o,
             RULE_LEGACY: _rule_no_legacy_names}


def lint_source(src: str, path: str,
                rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Lint one source under ``rules`` (default: all)."""
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, "syntax-error", str(e.msg))]
    lines = src.splitlines()
    out: List[Finding] = []
    for rule in (rules if rules is not None else ALL_RULES):
        out.extend(_RULE_FNS[rule](tree, path, lines))
    return sorted(out, key=lambda f: (f.line, f.rule))


def lint_file(path: str, root: str = ".",
              rules: Optional[Sequence[str]] = None) -> List[Finding]:
    rel = os.path.relpath(path, root).replace(os.sep, "/")
    with open(path, encoding="utf-8") as f:
        return lint_source(f.read(), rel, rules)


def _py_files(*dirs: str) -> List[str]:
    out = []
    for d in dirs:
        for base, _dirs, files in os.walk(d):
            if "__pycache__" not in base:
                out.extend(os.path.join(base, f) for f in sorted(files)
                           if f.endswith(".py"))
    return sorted(out)


def lint_tree(root: str = ".") -> List[Finding]:
    """``src/repro_torch`` under every rule; the port's tests
    (``tests/test_torch_*.py``) and ``chip_smoke.py`` under
    ``no-legacy-names`` (pytest rewrites test asserts; the smoke's asserts
    are its checks)."""
    findings: List[Finding] = []
    for path in _py_files(os.path.join(root, "src", "repro_torch")):
        findings.extend(lint_file(path, root))
    tests = os.path.join(root, "tests")
    aux = [os.path.join(tests, f) for f in sorted(os.listdir(tests))
           if f.startswith("test_torch_") and f.endswith(".py")] \
        if os.path.isdir(tests) else []
    smoke = os.path.join(root, "chip_smoke.py")
    aux += [smoke] if os.path.isfile(smoke) else []
    for path in aux:
        findings.extend(lint_file(path, root, rules=(RULE_LEGACY,)))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))
