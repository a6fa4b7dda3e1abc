"""Source lint: AST pass over ``src/repro_torch`` for host syncs in the
engine's loop bodies.

The rounds of a selection and the elements of a stream block run as a
Python loop that enqueues device work; one host read inside it stalls the
loop on the device every iteration. The loop bodies are named in
:data:`LOOP_BODIES` (a test fails if a listed name no longer exists), and
these rules hold inside them:

``host-sync``
    ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``; ``bool()`` /
    ``int()`` / ``float()`` of a tensor expression; an ``if`` / ``while``
    / conditional expression whose test is a tensor expression. A tensor
    expression holds a ``torch.`` call or a name bound to a tensor: a
    parameter that is unannotated or annotated as a tensor or a tensor
    tuple, or a name assigned from a tensor expression. ``x is None``,
    ``len(x)``, ``isinstance``, comparisons with a string and the host
    attributes of a tensor (``.shape``, ``.ndim``, ``.dtype``,
    ``.device``, ``.is_cuda``) are host values.
``np-in-loop``
    an ``np.`` call on a tensor name of a loop body.

and everywhere:

``float-eq``
    ``==`` / ``!=`` against a float literal. Threshold grids and gain
    comparisons must use a tolerance or integer exponents.

The reference's ``missing-static`` rule (a str or bool parameter of a
jitted function missing from ``static_argnames``) has no torch form: an
eager loop takes its configuration as Python values and compiles nothing,
so there is no static/traced split to get wrong. What it guarded — a
configuration value silently becoming data — cannot happen here.

Suppress a finding with a trailing ``# lint: allow(<rule>)`` comment on
the offending line. The tree carries exactly two: CELF's stopping-rule
tests, one scalar sync per inner iteration.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path

#: The loop bodies the host-sync rules apply to, per module (relative to
#: ``src/repro_torch``): dotted names of (possibly nested) functions.
LOOP_BODIES = {
    "core/engine.py": (
        "make_rounds_step.step", "make_lazy_step.step",
        "make_batched_rounds_step.step", "make_batched_lazy_step.step",
        "drive_selection_scan", "drive_selection_scan_batched"),
    "core/streaming.py": (
        "_element_step", "_offer_loop.offer", "_offer_block_batched"),
}

_ALLOW = re.compile(r"#\s*lint:\s*allow\(([\w\-,\s]+)\)")
_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_HOST_ATTRS = frozenset({"shape", "ndim", "dtype", "device", "is_cuda",
                         "numel", "dim", "size"})
#: parameter annotations that mark a tensor (or a tuple of tensors)
_TENSOR_ANNOTATIONS = frozenset({"Tensor", "torch.Tensor", "SieveState"})


@dataclasses.dataclass(frozen=True)
class LintFinding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _allow_comments(source: str) -> dict[int, set[str]]:
    """Line → rules of the ``# lint: allow(...)`` comments of ``source``
    (comments only: a docstring that quotes the marker allows nothing)."""
    out: dict[int, set[str]] = {}
    toks = tokenize.generate_tokens(io.StringIO(source).readline)
    for tok in toks:
        if tok.type == tokenize.COMMENT:
            m = _ALLOW.search(tok.string)
            if m:
                out[tok.start[0]] = {r.strip() for r in m.group(1).split(",")}
    return out


def allowed_lines(source: str, rule: str) -> list[int]:
    """Lines of ``source`` whose comment carries ``# lint: allow(<rule>)``."""
    return sorted(i for i, rules in _allow_comments(source).items()
                  if rule in rules)


def _dotted(node: ast.AST) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _targets(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


class _Taint:
    """Which names of one loop body hold tensors."""

    def __init__(self, fn: ast.AST):
        self.names: set[str] = set()
        for sub in ast.walk(fn):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                a = sub.args
                for p in [*a.posonlyargs, *a.args, *a.kwonlyargs,
                          *([a.vararg] if a.vararg else []),
                          *([a.kwarg] if a.kwarg else [])]:
                    ann = _dotted(p.annotation) if p.annotation else ""
                    if not ann or ann in _TENSOR_ANNOTATIONS:
                        self.names.add(p.arg)
        # assignments, to a fixed point
        assigns = [n for n in ast.walk(fn)
                   if isinstance(n, (ast.Assign, ast.AugAssign,
                                     ast.AnnAssign))]
        changed = True
        while changed:
            changed = False
            for n in assigns:
                if n.value is None or not self.tensor(n.value):
                    continue
                tg = n.targets if isinstance(n, ast.Assign) else [n.target]
                new = set().union(*(_targets(t) for t in tg)) - self.names
                if new:
                    self.names |= new
                    changed = True

    def tensor(self, node: ast.AST) -> bool:
        """Whether ``node`` is a tensor expression."""
        if isinstance(node, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            if any(isinstance(o, ast.Constant) and isinstance(o.value, str)
                   for o in [node.left, *node.comparators]):
                return False
            return any(self.tensor(o) for o in [node.left, *node.comparators])
        if isinstance(node, ast.Attribute):
            if node.attr in _HOST_ATTRS:
                return False
            return self.tensor(node.value)
        if isinstance(node, ast.Call):
            head = _dotted(node.func)
            if head.startswith("torch."):
                return True
            if head in ("len", "isinstance", "range", "type", "id",
                        "callable", "getattr", "hasattr"):
                return False
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in _HOST_ATTRS:
                    return False
                return self.tensor(node.func.value)
            return any(self.tensor(a) for a in node.args)
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Lambda):
            return False
        return any(self.tensor(ch) for ch in ast.iter_child_nodes(node))


class _Linter:
    def __init__(self, path: str, source: str):
        self.path = path
        self.allow = _allow_comments(source)
        self.findings: list[LintFinding] = []

    def _allowed(self, line: int, rule: str) -> bool:
        return rule in self.allow.get(line, ())

    def _emit(self, node: ast.AST, rule: str, message: str):
        if not self._allowed(node.lineno, rule):
            self.findings.append(
                LintFinding(self.path, node.lineno, rule, message))

    def check_loop_body(self, fn: ast.AST, label: str):
        taint = _Taint(fn)
        for node in ast.walk(fn):
            if isinstance(node, (ast.If, ast.While, ast.IfExp)) \
                    and taint.tensor(node.test):
                kind = {ast.If: "if", ast.While: "while",
                        ast.IfExp: "conditional"}[type(node)]
                self._emit(node, "host-sync",
                           f"Python {kind} on a tensor in loop body "
                           f"{label!r} — a host sync every iteration; use "
                           f"torch.where")
            elif isinstance(node, ast.Call):
                head = _dotted(node.func)
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _SYNC_METHODS \
                        and not head.startswith(("np.", "numpy.")):
                    self._emit(node, "host-sync",
                               f".{node.func.attr}() in loop body {label!r}"
                               f" — a host read every iteration")
                elif isinstance(node.func, ast.Name) \
                        and node.func.id in ("bool", "int", "float") \
                        and any(taint.tensor(a) for a in node.args):
                    self._emit(node, "host-sync",
                               f"{node.func.id}() of a tensor in loop body "
                               f"{label!r} — a host sync every iteration")
                elif head.startswith(("np.", "numpy.")) and any(
                        taint.tensor(a) for a in node.args):
                    self._emit(node, "np-in-loop",
                               f"numpy call {head!r} on a tensor in loop "
                               f"body {label!r} — a device-to-host copy")

    def check_float_eq(self, tree: ast.AST):
        for node in ast.walk(tree):
            if not isinstance(node, ast.Compare):
                continue
            operands = [node.left, *node.comparators]
            if any(isinstance(o, ast.Constant) and isinstance(o.value, float)
                   for o in operands) and \
                    any(isinstance(op, (ast.Eq, ast.NotEq))
                        for op in node.ops):
                self._emit(node, "float-eq",
                           "exact ==/!= against a float literal — compare "
                           "with a tolerance or an integer exponent")


def find_defs(tree: ast.AST) -> dict[str, ast.AST]:
    """Every function of a module by dotted nesting name."""
    out: dict[str, ast.AST] = {}

    def visit(node, prefix):
        for ch in ast.iter_child_nodes(node):
            if isinstance(ch, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = f"{prefix}{ch.name}"
                out.setdefault(name, ch)
                visit(ch, name + ".")
            elif isinstance(ch, ast.ClassDef):
                visit(ch, f"{prefix}{ch.name}.")
            else:
                visit(ch, prefix)

    visit(tree, "")
    return out


def lint_source(source: str, path: str = "<string>",
                loop_bodies: tuple = ()) -> list[LintFinding]:
    """Lint one module; ``loop_bodies`` are the dotted names of its loop
    bodies."""
    tree = ast.parse(source)
    lt = _Linter(path, source)
    defs = find_defs(tree)
    for name in loop_bodies:
        if name in defs:
            lt.check_loop_body(defs[name], name)
    lt.check_float_eq(tree)
    lt.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return lt.findings


def missing_loop_bodies(root) -> list[str]:
    """Names of :data:`LOOP_BODIES` that no longer exist under ``root``."""
    root = Path(root)
    missing = []
    for rel, names in LOOP_BODIES.items():
        p = root / rel
        defs = find_defs(ast.parse(p.read_text())) if p.exists() else {}
        missing += [f"{rel}:{n}" for n in names if n not in defs]
    return missing


def lint_tree(root) -> list[LintFinding]:
    """Lint every ``.py`` under ``root`` (``src/repro_torch``): the loop
    bodies of :data:`LOOP_BODIES` and float equality everywhere. A listed
    loop body that no longer exists is itself a finding."""
    root = Path(root)
    findings: list[LintFinding] = []
    for p in sorted(root.rglob("*.py")):
        rel = p.relative_to(root).as_posix()
        findings.extend(lint_source(p.read_text(), str(p),
                                    loop_bodies=LOOP_BODIES.get(rel, ())))
    findings += [LintFinding(m.split(":")[0], 0, "loop-body",
                             f"listed loop body {m} no longer exists")
                 for m in missing_loop_bodies(root)]
    return findings
