"""Source-level contract rules (Layer 1): ``RPR0xx`` over stdlib ASTs.

The port's counterpart of ``repro.analysis.rules``. Each rule machine-checks
one invariant of the port that otherwise lives only in prose (DESIGN.md,
the section references below, and ROADMAP's ground rules). Rules never
execute the port's code: they parse with :mod:`ast` and walk the tree, so
the linter runs anywhere, with or without torch or a GPU.

Rule catalogue:

========  ==================================================================
RPR001    no ad-hoc wall-clock timing (``time.perf_counter``/``time.time``/
          ``time.monotonic``) outside ``obs/trace.py`` — spans are the
          timing source (§10)
RPR002    no unbounded ``functools.lru_cache``/``functools.cache`` — every
          factory cache carries an explicit ``maxsize`` bound (§11)
RPR003    no float64 on the device path: ``torch.float64``/``torch.double``
          (and the complex128 forms) or ``.double()`` anywhere in a
          device-path module, or inside a hot function of any other module
          (§6 — float32 is the device dtype; host numpy float64, the
          oracle's, stays legal)
RPR004    float comparisons against small epsilon literals in the
          knife-edge modules must go through a NAMED guard
          (``FLEX_REL``/``_DEVICE_CEIL_EPS``/``_BETA_ONE_EPS``/... — §5/§6)
RPR005    no host sync (``.item()``/``.tolist()``/``.cpu()``/``.numpy()``/
          ``torch.cuda.synchronize``, ``float(x)``/``int(x)`` on a value
          that is not a host constant) inside a hot function
RPR006    ``donate_argnums`` only in the §11-whitelisted modules — inert in
          the port (see :func:`_check_donation`)
RPR007    no ``print``/``breakpoint``/``pdb`` in device-path modules (§9 —
          the counterpart of ``jax.debug.print``: hot-path code stays free
          of host round trips)
========  ==================================================================

**Hot functions.** The reference's RPR003/RPR005 walk the functions
reachable from a ``jax.jit`` factory. The port compiles no program: its
device work is eager torch ops and hand-written kernels. Its roots are the
functions that open a ``record_launch(...)`` block (a kernel launch) or an
``obs.compiled.program(...)`` block (a program key whose collectives are
counted), plus the device-path builders named in :data:`HOT_ROOTS`; edges
are any Name reference to another function of the same module, as in the
reference.

Each rule keeps the reference's code and contract text (the summary table
prints the same rows); its ``name`` and its check are the port's. In the
port, a "jit factory" is a hot root and a "callback primitive" a debug
print or breakpoint.

Suppression: a trailing ``# repro: noqa RPR0xx`` on the finding's line, or
a baseline entry in ``analysis-baseline-torch.json`` (see ``engine.py``).
"""

from __future__ import annotations

import ast
import dataclasses
import re

__all__ = ["Finding", "Rule", "RULES", "RULES_BY_CODE"]


# --------------------------------------------------------------------------
# Module classification (repo-relative paths with forward slashes)
# --------------------------------------------------------------------------

_LIB = "src/repro_torch/"
TIMING_SOURCE = _LIB + "obs/trace.py"

# The §6 device path: modules whose functions build or launch the card's
# work.
DEVICE_PATH_FILES = frozenset(_LIB + p for p in (
    "engine/backend.py",
    "engine/scenarios.py",
    "engine/plan.py",
    "engine/mesh.py",
    "learn/replay.py",
    "core/market.py",
))
DEVICE_PATH_PREFIXES = (_LIB + "kernels/",)

# The §5/§6 knife-edge modules: every epsilon tolerance is a named guard.
GUARDED_FILES = frozenset(_LIB + p for p in (
    "core/simulate.py",
    "core/scheduler.py",
    "core/dealloc.py",
))

# The documented epsilon guards plus the shape every new guard must take
# (a module-level SHOUTING_CASE constant, optional leading underscore).
KNOWN_GUARDS = frozenset({
    "FLEX_REL", "FLEX_ABS", "_DEVICE_CEIL_EPS", "_DEVICE_DUST",
    "_BETA_ONE_EPS", "_avail_threshold",
})
_NAMED_GUARD_RE = re.compile(r"^_?[A-Z][A-Z0-9_]{2,}$")

_TIMER_NAMES = frozenset({
    "perf_counter", "perf_counter_ns", "time", "monotonic", "monotonic_ns",
    "process_time", "process_time_ns",
})

# Hot roots besides the record_launch/program openers: the device-path
# builders that run torch ops on the card outside any launch.
HOT_ROOTS = {
    _LIB + "engine/scenarios.py": frozenset({"_device_synth",
                                             "_device_views"}),
    _LIB + "engine/plan.py": frozenset({"_device_plans", "_device_cells"}),
    _LIB + "core/market.py": frozenset({"stacked_view_tensors"}),
}
_HOT_BLOCKS = frozenset({"record_launch", "program"})

_F64_NAMES = frozenset({"float64", "double", "complex128", "cdouble"})
_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_DEBUG_CALLS = frozenset({"print", "breakpoint"})


def _in_device_path(rel: str) -> bool:
    return rel in DEVICE_PATH_FILES or rel.startswith(DEVICE_PATH_PREFIXES)


def _in_library(rel: str) -> bool:
    return rel.startswith(_LIB)


# --------------------------------------------------------------------------
# Finding / Rule containers
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    code: str
    path: str
    line: int
    col: int
    message: str
    line_text: str = ""

    @property
    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def to_dict(self) -> dict:
        return {"code": self.code, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "line_text": self.line_text}


@dataclasses.dataclass(frozen=True)
class Rule:
    code: str
    name: str
    contract: str
    applies: "callable"
    check: "callable"


def _terminal(node: ast.AST) -> str | None:
    """Rightmost identifier of a Name/Attribute chain (``a.b.c`` -> "c")."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _mk(code, node, message, lines, path) -> Finding:
    line = getattr(node, "lineno", 1)
    text = lines[line - 1].strip() if 0 < line <= len(lines) else ""
    return Finding(code=code, path=path, line=line,
                   col=getattr(node, "col_offset", 0), message=message,
                   line_text=text)


# --------------------------------------------------------------------------
# RPR001 — timing outside obs/trace.py
# --------------------------------------------------------------------------

def _check_timing(tree, lines, path):
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "time" and node.attr in _TIMER_NAMES):
            out.append(_mk(
                "RPR001", node,
                f"ad-hoc wall-clock timing time.{node.attr} outside "
                f"obs/trace.py — measure with repro_torch.obs.span (§10)",
                lines, path))
        elif (isinstance(node, ast.ImportFrom) and node.module == "time"
                and any(a.name in _TIMER_NAMES for a in node.names)):
            out.append(_mk(
                "RPR001", node,
                "importing wall-clock timers from `time` outside "
                "obs/trace.py — measure with repro_torch.obs.span (§10)",
                lines, path))
    return out


# --------------------------------------------------------------------------
# RPR002 — unbounded caches
# --------------------------------------------------------------------------

def _check_unbounded_cache(tree, lines, path):
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _terminal(node.func) == "lru_cache":
            unbounded = False
            for kw in node.keywords:
                if kw.arg == "maxsize" and isinstance(kw.value, ast.Constant) \
                        and kw.value.value is None:
                    unbounded = True
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and node.args[0].value is None:
                unbounded = True
            if unbounded:
                out.append(_mk(
                    "RPR002", node,
                    "unbounded lru_cache(maxsize=None) — long-lived "
                    "processes must not accumulate entries forever; give "
                    "it an explicit bound (§11)", lines, path))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                t = _terminal(dec) if not isinstance(dec, ast.Call) else None
                if t == "lru_cache":
                    out.append(_mk(
                        "RPR002", dec,
                        "bare @lru_cache is unbounded — give it an "
                        "explicit maxsize bound (§11)", lines, path))
                elif t == "cache":
                    out.append(_mk(
                        "RPR002", dec,
                        "@functools.cache is unbounded — use "
                        "lru_cache(maxsize=N) (§11)", lines, path))
    return out


# --------------------------------------------------------------------------
# Shared: the intra-module hot-function graph (RPR003 / RPR005)
# --------------------------------------------------------------------------

def _own_nodes(fn: ast.AST):
    """Walk a function's own body, not descending into nested defs."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(ast.iter_child_nodes(node))


def _opens_hot_block(fn: ast.AST) -> bool:
    """True if the function itself opens ``with record_launch(...)`` or
    ``with program(...)`` (any spelling: ``compiled.program``...)."""
    for node in _own_nodes(fn):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                ctx = item.context_expr
                if isinstance(ctx, ast.Call) \
                        and _terminal(ctx.func) in _HOT_BLOCKS:
                    return True
    return False


def _hot_functions(tree, path: str) -> list[ast.AST]:
    """Function nodes reachable from a hot root of the module.

    Roots: functions that open a ``record_launch``/``program`` block, and
    the names :data:`HOT_ROOTS` lists for the module. Edges: any Name
    reference to another module function (an over-approximation, as the
    reference's jit graph).
    """
    funcs: dict[str, list[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            funcs.setdefault(node.name, []).append(node)

    roots = {name for name, nodes in funcs.items()
             if any(_opens_hot_block(fn) for fn in nodes)}
    roots |= HOT_ROOTS.get(path, frozenset())

    edges: dict[str, set[str]] = {}
    for name, nodes in funcs.items():
        refs: set[str] = set()
        for fn in nodes:
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Name) and sub.id in funcs \
                        and sub.id != name:
                    refs.add(sub.id)
        edges[name] = refs

    seen: set[str] = set()
    frontier = list(roots & funcs.keys())
    while frontier:
        name = frontier.pop()
        if name in seen:
            continue
        seen.add(name)
        frontier.extend(edges.get(name, ()))
    return [fn for name in sorted(seen) for fn in funcs[name]]


def _module_names(tree) -> set[str]:
    """Names bound at module level: imports, constants, functions and
    classes — host objects, never a tensor a hot function computes."""
    names: set[str] = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                names.update(n.id for n in ast.walk(t)
                             if isinstance(n, ast.Name))
    return names


def _host_constant(node, module: set[str]) -> bool:
    """True for an expression of literals and module-level names only
    (``int(_MIX1)``, ``float(np.float32(1.0))``): a host constant, which
    no conversion can sync on."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        return node.id in module
    if isinstance(node, ast.Attribute):
        return _host_constant(node.value, module)
    if isinstance(node, ast.UnaryOp):
        return _host_constant(node.operand, module)
    if isinstance(node, ast.BinOp):
        return _host_constant(node.left, module) \
            and _host_constant(node.right, module)
    if isinstance(node, ast.Call):
        return _host_constant(node.func, module) \
            and all(_host_constant(a, module) for a in node.args) \
            and all(_host_constant(k.value, module) for k in node.keywords)
    return False


# --------------------------------------------------------------------------
# RPR003 — float64 on the device path
# --------------------------------------------------------------------------

def _f64_nodes(nodes):
    """(node, spelling) of every torch float64 form among ``nodes``."""
    for node in nodes:
        if (isinstance(node, ast.Attribute) and node.attr in _F64_NAMES
                and isinstance(node.value, ast.Name)
                and node.value.id == "torch"):
            yield node, f"torch.{node.attr}"
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr in ("double", "cdouble")
              and not node.args and not node.keywords):
            yield node, f".{node.func.attr}()"


def _check_float64(tree, lines, path):
    out = []
    if _in_device_path(path):
        for node, what in _f64_nodes(ast.walk(tree)):
            out.append(_mk(
                "RPR003", node,
                f"{what} in a device-path module — the device dtype is "
                f"float32; the float64 oracle is host numpy (§6)",
                lines, path))
        return out
    for fn in _hot_functions(tree, path):
        for node, what in _f64_nodes(_own_nodes(fn)):
            out.append(_mk(
                "RPR003", node,
                f"{what} inside hot function `{fn.name}` — a float64 "
                f"tensor on the card flips knife-edge slots (§6)",
                lines, path))
    return out


# --------------------------------------------------------------------------
# RPR004 — unguarded epsilon comparisons in the knife-edge modules
# --------------------------------------------------------------------------

def _check_epsilon_guards(tree, lines, path):
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Compare):
            continue
        if not any(isinstance(op, (ast.Lt, ast.LtE, ast.Gt, ast.GtE))
                   for op in node.ops):
            continue
        eps_literals = []
        guarded = False
        for sub in ast.walk(node):
            if isinstance(sub, ast.Constant) and isinstance(sub.value, float) \
                    and 0.0 < abs(sub.value) < 1e-3:
                eps_literals.append(sub.value)
            name = _terminal(sub) if isinstance(
                sub, (ast.Name, ast.Attribute)) else None
            if name and (name in KNOWN_GUARDS or _NAMED_GUARD_RE.match(name)):
                guarded = True
        if eps_literals and not guarded:
            lits = ", ".join(repr(v) for v in sorted(set(eps_literals)))
            out.append(_mk(
                "RPR004", node,
                f"float comparison against inline epsilon {lits} — "
                f"knife-edge tolerances must reference a named guard "
                f"(FLEX_REL / _DEVICE_CEIL_EPS / ... , §5/§6)",
                lines, path))
    return out


# --------------------------------------------------------------------------
# RPR005 — host sync inside hot functions
# --------------------------------------------------------------------------

def _check_host_sync(tree, lines, path):
    out = []
    module = None
    for fn in _hot_functions(tree, path):
        for node in _own_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS:
                out.append(_mk(
                    "RPR005", node,
                    f".{f.attr}() inside hot function `{fn.name}` waits "
                    f"for the card (a device-to-host read)", lines, path))
            elif (isinstance(f, ast.Attribute) and f.attr == "synchronize"
                  and _terminal(f.value) == "cuda"):
                out.append(_mk(
                    "RPR005", node,
                    f"torch.cuda.synchronize inside hot function "
                    f"`{fn.name}`", lines, path))
            elif (isinstance(f, ast.Name) and f.id in ("float", "int")
                  and node.args):
                if module is None:
                    module = _module_names(tree)
                if all(_host_constant(a, module) for a in node.args):
                    continue
                out.append(_mk(
                    "RPR005", node,
                    f"{f.id}(...) on a non-constant inside hot function "
                    f"`{fn.name}` reads a tensor's value on the host",
                    lines, path))
    return out


# --------------------------------------------------------------------------
# RPR006 — donation whitelist (inert in the port)
# --------------------------------------------------------------------------

def _check_donation(tree, lines, path):
    """The reference's donation rule, kept for its table and its code.

    ``donate_argnums`` is a ``jax.jit`` argument: torch has no buffer
    donation, so no port source can spell it and the rule applies to no
    path (its ``applies`` is always false). What donation guarded — a
    program must not invalidate its caller's buffers — is checked at run
    time instead: Layer 2's ``mutation`` check asserts that no program
    argument's ``tensor._version`` moves, save the sharded fold's
    accumulator, the reference's one whitelisted donation.
    """
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg in ("donate_argnums", "donate_argnames"):
                    out.append(_mk(
                        "RPR006", kw.value,
                        "buffer donation outside the §11 whitelist "
                        "(learn/replay.py) — donated inputs invalidate "
                        "cross-call cached buffers", lines, path))
    return out


# --------------------------------------------------------------------------
# RPR007 — debug prints and breakpoints in device-path modules
# --------------------------------------------------------------------------

def _check_callbacks(tree, lines, path):
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in _DEBUG_CALLS:
            out.append(_mk(
                "RPR007", node,
                f"{node.func.id}() in a device-path module — a print of a "
                f"tensor reads it back to the host; hot-path code stays "
                f"free of host round trips (§9)", lines, path))
        elif (isinstance(node, ast.Attribute)
              and isinstance(node.value, ast.Name)
              and node.value.id == "pdb"):
            out.append(_mk(
                "RPR007", node,
                f"pdb.{node.attr} in a device-path module (§9)",
                lines, path))
        elif (isinstance(node, ast.Import)
              and any(a.name == "pdb" for a in node.names)) or (
                isinstance(node, ast.ImportFrom) and node.module == "pdb"):
            out.append(_mk(
                "RPR007", node,
                "importing pdb into a device-path module (§9)",
                lines, path))
    return out


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

RULES = (
    Rule("RPR001", "timing-outside-trace",
         "wall-clock timing only in obs/trace.py; spans are the timing "
         "source (§10)",
         lambda rel: _in_library(rel) and rel != TIMING_SOURCE,
         _check_timing),
    Rule("RPR002", "unbounded-cache",
         "every functools cache carries an explicit maxsize bound (§11)",
         _in_library,
         _check_unbounded_cache),
    Rule("RPR003", "float64-on-device-path",
         "no f64 enters a traced device program outside the documented "
         "oracle boundaries (§6)",
         _in_library,
         _check_float64),
    Rule("RPR004", "unguarded-epsilon",
         "knife-edge float comparisons reference named epsilon guards "
         "(§5/§6)",
         lambda rel: rel in GUARDED_FILES,
         _check_epsilon_guards),
    Rule("RPR005", "host-sync-in-hot-function",
         "no host sync inside functions reachable from a jit factory",
         _in_library,
         _check_host_sync),
    Rule("RPR006", "donation-whitelist",
         "donate_argnums only in §11-whitelisted modules",
         lambda rel: False,
         _check_donation),
    Rule("RPR007", "debug-free-hot-path",
         "no callback primitives in device-path modules (§9)",
         _in_device_path,
         _check_callbacks),
)

RULES_BY_CODE = {r.code: r for r in RULES}
