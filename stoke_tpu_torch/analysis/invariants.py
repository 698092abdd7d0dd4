"""Invariant linter: the port's codified disciplines as machine-checked
rules.

The port's counterpart of ``stoke_tpu/analysis/invariants.py``: the same
AST rules, run over the port's tree (``stoke_tpu_torch/``) against the
port's manifests under ``stoke_tpu_torch/analysis/manifests/``:

- **Wire-format append-only** (``wire-append-only``): the packed-vector
  layouts that cross process or version boundaries (``SENTINEL_FIELDS``,
  ``FLEET_SIGNALS``, ``NUMERICS_STATS`` and the other JSONL blocks) are
  pinned in ``wire_formats.json``; the port's lists are the JAX
  package's, so a port process and a JAX process read each other's rows.
  Any reorder, removal or insert fails, and so does an append that did not
  update the manifest.
- **Config-field status-rule coverage** (``config-guard``): every
  dataclass field in ``stoke_tpu_torch/configs.py`` must be reachable
  from ``stoke_tpu_torch/status.py`` (an attribute read or an identifier
  string), or waived with a reason in ``config_waivers.json``. A waiver
  naming no field is a finding itself (``config-waiver-unknown``).
- **Nullable-JSONL discipline** (``jsonl-schema``): every namespaced key
  an ``event_fields``-family emitter of the port can produce must be in
  ``stoke_tpu_torch/telemetry/events.py``'s ``STEP_EVENT_FIELDS`` with a
  nullable, non-required kind.
- **Banned APIs**: ``banned-jax-import``, a ``jax``, ``jaxlib``,
  ``flax``, ``optax``, ``orbax`` or ``stoke_tpu`` import in any module of
  the port, in any scope (the port imports none of them; only its tests
  do), or a module-scope ``jax`` import in a listed jax-free module (the
  JAX rule); ``banned-torch-import``, a module-scope ``torch`` import in
  the torch-free modules (this linter, the autotuner's search and the
  drivers that load them by file, which must start with no backend); and
  ``banned-device-get``, a per-dispatch host fetch (``.item()``,
  ``.cpu()``, ``.numpy()``, ``.tolist()``, ``torch.cuda.synchronize``,
  ``device_get``) in the engines' step paths. A fetch the design needs
  (the serving engine's one token readback a dispatch, as the JAX
  engine's ``np.asarray``) is waived by its function in
  ``host_fetch_waivers.json``, with the reason.

Deliberately **torch-free and AST-based** (stdlib only), so
``scripts/stoke_lint_torch.py`` loads this file by FILE and runs before any
backend exists. The torch half, the program auditor over recorded
program traces, is :mod:`stoke_tpu_torch.analysis.program`, which shares
:class:`Finding`.
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

#: linter identity, stamped into --json output
LINT_VERSION = "stoke_tpu_torch.analysis/v1"

#: committed manifests (repo-relative)
WIRE_MANIFEST_PATH = "stoke_tpu_torch/analysis/manifests/wire_formats.json"
CONFIG_WAIVERS_PATH = "stoke_tpu_torch/analysis/manifests/config_waivers.json"
HOST_FETCH_WAIVERS_PATH = (
    "stoke_tpu_torch/analysis/manifests/host_fetch_waivers.json")

#: the config/validation pair the coverage rule reads
CONFIGS_PATH = "stoke_tpu_torch/configs.py"
STATUS_PATH = "stoke_tpu_torch/status.py"
#: the step-event schema the JSONL rule reads
EVENTS_SCHEMA_PATH = "stoke_tpu_torch/telemetry/events.py"

#: the port's package: no module of it imports the JAX stack, in any scope
PORT_PACKAGE = "stoke_tpu_torch"
#: import roots the port never loads (``stoke_tpu`` is the JAX package;
#: ``stoke_tpu_torch`` is a root of its own)
BANNED_PORT_IMPORTS: Tuple[str, ...] = (
    "jax", "jaxlib", "flax", "optax", "orbax", "stoke_tpu",
)

#: modules that must never import jax/jaxlib at MODULE scope (the JAX
#: rule; the port's drivers that load its torch-free modules by file)
JAX_FREE_MODULES: Tuple[str, ...] = (
    "scripts/stoke_lint_torch.py",
    "scripts/autotune_torch.py",
)

#: modules that must never import torch at MODULE scope: they start
#: before any backend (the lint CLI loads this file in-process; the
#: autotune driver's parent never touches a card)
TORCH_FREE_MODULES: Tuple[str, ...] = (
    "stoke_tpu_torch/autotune.py",
    "stoke_tpu_torch/analysis/invariants.py",
    "scripts/stoke_lint_torch.py",
    "scripts/autotune_torch.py",
)

#: step-path modules where a per-dispatch host fetch is banned (fetches
#: ride the sentinel row and the telemetry cadence instead)
DEVICE_GET_BANNED_MODULES: Tuple[str, ...] = (
    "stoke_tpu_torch/engine.py",
    "stoke_tpu_torch/serving/engine.py",
)
#: the attribute calls that fetch to the host (or wait for the card)
HOST_FETCH_ATTRS: Tuple[str, ...] = (
    "item", "cpu", "numpy", "tolist", "synchronize", "device_get",
)

#: modules whose ``event_fields``-family functions emit namespaced JSONL
#: keys conditionally (the nullable-block discipline)
JSONL_EMITTER_MODULES: Tuple[str, ...] = (
    "stoke_tpu_torch/telemetry/fleet.py",
    "stoke_tpu_torch/telemetry/numerics.py",
    "stoke_tpu_torch/resilience.py",
    "stoke_tpu_torch/serving/telemetry.py",
    "stoke_tpu_torch/serving/slo.py",
    "stoke_tpu_torch/serving/roofline.py",
    "stoke_tpu_torch/telemetry/memory.py",
)
#: emitter function names the JSONL rule inspects
_JSONL_EMITTER_FNS = ("event_fields", "_event_fields", "_base_event_fields")
#: namespaced key prefixes that identify a conditionally-emitted field
_JSONL_NAMESPACES = ("fleet/", "resilience/", "serve/", "numerics/", "mem/")


@dataclass
class Finding:
    """One lint/audit violation: where, which rule, and always the remedy,
    named the way status.py rules name theirs. Shared by the torch-free
    linter and the program auditor (whose findings use a
    ``<trace:program>`` pseudo-file and line 0)."""

    rule: str
    file: str
    line: int
    message: str
    remedy: str
    severity: str = "error"

    def format(self) -> str:
        return (
            f"{self.file}:{self.line}: [{self.rule}] {self.message} "
            f"— remedy: {self.remedy}"
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "rule": self.rule,
            "file": self.file,
            "line": self.line,
            "message": self.message,
            "remedy": self.remedy,
            "severity": self.severity,
        }


# --------------------------------------------------------------------------- #
# shared AST helpers
# --------------------------------------------------------------------------- #


def _parse(path: str) -> ast.Module:
    with open(path, "r") as f:
        return ast.parse(f.read(), filename=path)


def _rel(repo_root: str, path: str) -> str:
    try:
        return os.path.relpath(path, repo_root)
    except ValueError:
        return path


def _find_tuple_assign(
    tree: ast.Module, name: str
) -> Optional[Tuple[List[str], int]]:
    """Top-level ``NAME = ("a", "b", ...)`` → (fields, lineno); None when
    the symbol is missing or not a literal string tuple/list."""
    for node in tree.body:
        if isinstance(node, ast.Assign):
            targets = [
                t.id for t in node.targets if isinstance(t, ast.Name)
            ]
            if name not in targets:
                continue
            if isinstance(node.value, (ast.Tuple, ast.List)) and all(
                isinstance(e, ast.Constant) and isinstance(e.value, str)
                for e in node.value.elts
            ):
                return (
                    [e.value for e in node.value.elts],
                    node.lineno,
                )
            return None
    return None


def _module_scope_walk(tree: ast.Module):
    """Yield nodes reachable WITHOUT entering a function/lambda body —
    module scope including ``if``/``try`` blocks, which is exactly where
    an eager import hides."""
    stack: List[ast.AST] = [tree]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda),
            ):
                continue
            stack.append(child)


# --------------------------------------------------------------------------- #
# rule: wire-format append-only
# --------------------------------------------------------------------------- #


def load_wire_manifest(repo_root: str) -> Optional[List[Dict[str, Any]]]:
    path = os.path.join(repo_root, WIRE_MANIFEST_PATH)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)["wire_formats"]


def check_wire_formats(
    repo_root: str,
    manifest: Optional[Sequence[Dict[str, Any]]] = None,
) -> List[Finding]:
    """Append-only wire formats: for each manifest entry ``{file, name,
    fields}``, the committed field list must be a PREFIX of the current
    tuple (reorder/remove/insert between pinned fields = a host on the
    old code misreads every later slot), and the current tuple must not
    have grown past the manifest without the manifest growing with it
    (the manifest is the reviewed contract, not a cache)."""
    findings: List[Finding] = []
    if manifest is None:
        manifest = load_wire_manifest(repo_root)
        if manifest is None:
            return [
                Finding(
                    rule="wire-append-only",
                    file=WIRE_MANIFEST_PATH,
                    line=0,
                    message="wire-format manifest is missing",
                    remedy=(
                        "commit analysis/manifests/wire_formats.json "
                        "seeded from the current SENTINEL_FIELDS / "
                        "FLEET_SIGNALS / NUMERICS_STATS tuples"
                    ),
                )
            ]
    for entry in manifest:
        rel = entry["file"]
        name = entry["name"]
        pinned = list(entry["fields"])
        path = os.path.join(repo_root, rel)
        if not os.path.exists(path):
            findings.append(
                Finding(
                    rule="wire-append-only",
                    file=rel,
                    line=0,
                    message=f"wire-format module {rel!r} not found",
                    remedy=(
                        f"restore the module or update the {name} entry "
                        f"in {WIRE_MANIFEST_PATH}"
                    ),
                )
            )
            continue
        found = _find_tuple_assign(_parse(path), name)
        if found is None:
            findings.append(
                Finding(
                    rule="wire-append-only",
                    file=rel,
                    line=0,
                    message=(
                        f"{name} is not a top-level literal string tuple "
                        f"(the lintable wire-format form)"
                    ),
                    remedy=(
                        f"keep {name} a module-level tuple of string "
                        f"literals so the append-only check can read it"
                    ),
                )
            )
            continue
        current, line = found
        if current[: len(pinned)] != pinned:
            # name the first divergent slot — that is the field a host on
            # the old layout would misread
            idx = next(
                (
                    i
                    for i, p in enumerate(pinned)
                    if i >= len(current) or current[i] != p
                ),
                0,
            )
            got = current[idx] if idx < len(current) else "<removed>"
            findings.append(
                Finding(
                    rule="wire-append-only",
                    file=rel,
                    line=line,
                    message=(
                        f"{name} is a wire format and its committed "
                        f"layout was reordered/removed: slot {idx} is "
                        f"pinned to {pinned[idx]!r} but the tree has "
                        f"{got!r} (hosts on mixed code versions would "
                        f"silently misread every later slot)"
                    ),
                    remedy=(
                        f"never reorder or remove {name} entries — "
                        f"append new fields at the end and keep old "
                        f"slots in place (the manifest's comment, "
                        f"'append-only wire formats')"
                    ),
                )
            )
        elif len(current) > len(pinned):
            extra = current[len(pinned):]
            findings.append(
                Finding(
                    rule="wire-append-only",
                    file=rel,
                    line=line,
                    message=(
                        f"{name} grew {extra} past the committed "
                        f"manifest (append is legal but must be "
                        f"reviewed as a wire-format change)"
                    ),
                    remedy=(
                        f"append {extra} to the {name} entry in "
                        f"{WIRE_MANIFEST_PATH} in the same PR"
                    ),
                )
            )
    return findings


# --------------------------------------------------------------------------- #
# rule: config-field status coverage
# --------------------------------------------------------------------------- #


def _dataclass_fields(
    tree: ast.Module,
) -> Dict[str, List[Tuple[str, int]]]:
    """``{class_name: [(field, lineno), ...]}`` for every @dataclass in
    the module."""
    out: Dict[str, List[Tuple[str, int]]] = {}
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        if not any(
            (isinstance(d, ast.Name) and d.id == "dataclass")
            or (isinstance(d, ast.Attribute) and d.attr == "dataclass")
            or (
                isinstance(d, ast.Call)
                and (
                    (
                        isinstance(d.func, ast.Name)
                        and d.func.id == "dataclass"
                    )
                    or (
                        isinstance(d.func, ast.Attribute)
                        and d.func.attr == "dataclass"
                    )
                )
            )
            for d in node.decorator_list
        ):
            continue
        fields = [
            (stmt.target.id, stmt.lineno)
            for stmt in node.body
            if isinstance(stmt, ast.AnnAssign)
            and isinstance(stmt.target, ast.Name)
        ]
        out[node.name] = fields
    return out


def _guarded_names(status_tree: ast.Module, configs_tree: ast.Module) -> set:
    """Names the validation layer can 'reach': attribute accesses on
    simple names (``cfg.dtype`` — NOT call results, string methods, or
    dotted modules like ``os.path.join``, whose ``.join``/``.get``
    would silently 'cover' any config field sharing a common method
    name) and identifier string constants (the ``getattr(cfg, name)``
    loop form) anywhere in status.py, plus the same inside configs.py's
    module-level FUNCTIONS (the resolver-function allowance —
    ``comm_shard_updates`` is the single source of truth status rules
    call into, so the fields it reads are guarded)."""

    def _collect(nodes, names):
        for node in nodes:
            if isinstance(node, ast.Attribute):
                # Name base: cfg.dtype; Subscript base: the rule-table
                # s["grad_clip"].clip_value form.  Calls, string
                # literals, and dotted modules stay excluded.
                if isinstance(node.value, (ast.Name, ast.Subscript)):
                    names.add(node.attr)
            elif isinstance(node, ast.Constant) and isinstance(
                node.value, str
            ):
                if node.value.isidentifier():
                    names.add(node.value)

    names: set = set()
    _collect(ast.walk(status_tree), names)
    for node in configs_tree.body:
        if isinstance(node, ast.FunctionDef):
            _collect(ast.walk(node), names)
    return names


def load_config_waivers(repo_root: str) -> Optional[Dict[str, str]]:
    path = os.path.join(repo_root, CONFIG_WAIVERS_PATH)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)["waivers"]


def check_config_coverage(
    repo_root: str,
    configs_path: Optional[str] = None,
    status_path: Optional[str] = None,
    waivers: Optional[Dict[str, str]] = None,
) -> List[Finding]:
    """Every dataclass field in configs.py must be reachable from a
    status.py rule (attribute access or identifier-string reference) or
    explicitly waived with a reason.  Waiver entries naming a class or
    field that does not exist are findings themselves — a stale waiver
    silently re-opens the hole it once documented."""
    findings: List[Finding] = []
    configs_path = configs_path or os.path.join(repo_root, CONFIGS_PATH)
    status_path = status_path or os.path.join(repo_root, STATUS_PATH)
    if waivers is None:
        waivers = load_config_waivers(repo_root)
        if waivers is None:
            return [
                Finding(
                    rule="config-guard",
                    file=CONFIG_WAIVERS_PATH,
                    line=0,
                    message="config-waiver manifest is missing",
                    remedy=(
                        "commit analysis/manifests/config_waivers.json "
                        "({\"waivers\": {\"Class.field\": \"reason\"}})"
                    ),
                )
            ]
    configs_tree = _parse(configs_path)
    status_tree = _parse(status_path)
    classes = _dataclass_fields(configs_tree)
    guarded = _guarded_names(status_tree, configs_tree)
    configs_rel = _rel(repo_root, configs_path)

    # loud waiver validation first: unknown entries are findings
    for key, reason in waivers.items():
        cls, _, fname = key.partition(".")
        known = cls in classes and fname in {f for f, _ in classes[cls]}
        if not known:
            findings.append(
                Finding(
                    rule="config-waiver-unknown",
                    file=CONFIG_WAIVERS_PATH,
                    line=0,
                    message=(
                        f"waiver names unknown config field {key!r} "
                        f"(reason on file: {reason!r})"
                    ),
                    remedy=(
                        "remove the stale waiver entry or fix its "
                        "Class.field spelling — a waiver that matches "
                        "nothing guards nothing"
                    ),
                )
            )
        elif not (isinstance(reason, str) and reason.strip()):
            findings.append(
                Finding(
                    rule="config-waiver-unknown",
                    file=CONFIG_WAIVERS_PATH,
                    line=0,
                    message=f"waiver {key!r} has no reason",
                    remedy=(
                        "every waiver documents WHY the knob needs no "
                        "status rule — write the reason"
                    ),
                )
            )

    for cls, fields in classes.items():
        for fname, line in fields:
            if fname in guarded:
                continue
            if f"{cls}.{fname}" in waivers:
                continue
            findings.append(
                Finding(
                    rule="config-guard",
                    file=configs_rel,
                    line=line,
                    message=(
                        f"{cls}.{fname} is not reachable from any "
                        f"status.py rule — an illegal or typo'd value "
                        f"would be silently ignored"
                    ),
                    remedy=(
                        f"add a status.py rule that validates "
                        f"{cls}.{fname} (rejecting illegal combinations "
                        f"with the remedy named), or waive it with a "
                        f"reason in {CONFIG_WAIVERS_PATH}"
                    ),
                )
            )
    return findings


# --------------------------------------------------------------------------- #
# rule: nullable-JSONL discipline
# --------------------------------------------------------------------------- #


def _schema_fields(events_tree: ast.Module) -> Dict[str, Tuple[bool, str]]:
    """Parse ``STEP_EVENT_FIELDS`` from events.py's AST: ``{field:
    (required, kind)}``."""
    for node in events_tree.body:
        if isinstance(node, ast.AnnAssign) and isinstance(
            node.target, ast.Name
        ):
            if node.target.id != "STEP_EVENT_FIELDS":
                continue
            value = node.value
        elif isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "STEP_EVENT_FIELDS"
            for t in node.targets
        ):
            value = node.value
        else:
            continue
        out: Dict[str, Tuple[bool, str]] = {}
        if isinstance(value, ast.Dict):
            for k, v in zip(value.keys, value.values):
                if not (
                    isinstance(k, ast.Constant)
                    and isinstance(k.value, str)
                    and isinstance(v, ast.Tuple)
                    and len(v.elts) == 2
                    and all(isinstance(e, ast.Constant) for e in v.elts)
                ):
                    continue
                out[k.value] = (bool(v.elts[0].value), str(v.elts[1].value))
        return out
    return {}


def _emitted_keys(tree: ast.Module) -> List[Tuple[str, int]]:
    """Namespaced string keys an ``event_fields``-family function can
    emit: literal dict keys and ``out["key"] = ...`` subscript stores."""
    keys: List[Tuple[str, int]] = []
    for node in ast.walk(tree):
        if (
            isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node.name in _JSONL_EMITTER_FNS
        ):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Dict):
                    for k in sub.keys:
                        if isinstance(k, ast.Constant) and isinstance(
                            k.value, str
                        ):
                            keys.append((k.value, k.lineno))
                elif isinstance(sub, ast.Assign):
                    for t in sub.targets:
                        if (
                            isinstance(t, ast.Subscript)
                            and isinstance(t.slice, ast.Constant)
                            and isinstance(t.slice.value, str)
                        ):
                            keys.append((t.slice.value, t.lineno))
    return [
        (k, ln)
        for k, ln in keys
        if any(k.startswith(p) for p in _JSONL_NAMESPACES)
    ]


def check_jsonl_schema(
    repo_root: str,
    emitters: Optional[Sequence[str]] = None,
    schema_path: Optional[str] = None,
) -> List[Finding]:
    """Conditionally-emitted JSONL keys must exist in the step-event
    schema with a NULLABLE, non-required kind: a key the schema does not
    know fails validation at emit time (or worse, silently passes when
    validation is off and breaks every reader), and a required kind
    contradicts 'the field is absent without the config'."""
    findings: List[Finding] = []
    schema_path = schema_path or os.path.join(repo_root, EVENTS_SCHEMA_PATH)
    schema = _schema_fields(_parse(schema_path))
    if not schema:
        return [
            Finding(
                rule="jsonl-schema",
                file=_rel(repo_root, schema_path),
                line=0,
                message=(
                    "STEP_EVENT_FIELDS not found as a literal dict — the "
                    "JSONL discipline cannot be checked"
                ),
                remedy=(
                    "keep STEP_EVENT_FIELDS a module-level literal dict "
                    "of field -> (required, kind)"
                ),
            )
        ]
    for rel in emitters if emitters is not None else JSONL_EMITTER_MODULES:
        path = os.path.join(repo_root, rel)
        if not os.path.exists(path):
            continue
        for key, line in _emitted_keys(_parse(path)):
            if key not in schema:
                findings.append(
                    Finding(
                        rule="jsonl-schema",
                        file=rel,
                        line=line,
                        message=(
                            f"event_fields emits {key!r} which is not in "
                            f"events.py STEP_EVENT_FIELDS — "
                            f"validate_step_event would reject every "
                            f"record carrying it"
                        ),
                        remedy=(
                            f"declare {key!r} in STEP_EVENT_FIELDS with "
                            f"a nullable kind (and document its "
                            f"semantics there — the schema is the "
                            f"single source of truth)"
                        ),
                    )
                )
                continue
            required, kind = schema[key]
            if required or not kind.startswith("nullable"):
                findings.append(
                    Finding(
                        rule="jsonl-schema",
                        file=rel,
                        line=line,
                        message=(
                            f"conditionally-emitted key {key!r} is "
                            f"declared {'required' if required else ''}"
                            f"{' ' if required else ''}kind={kind!r} in "
                            f"the schema — but subsystem fields are "
                            f"ABSENT without their config, so the "
                            f"schema must allow that"
                        ),
                        remedy=(
                            f"declare {key!r} optional with a "
                            f"nullable_* kind in STEP_EVENT_FIELDS"
                        ),
                    )
                )
    return findings


# --------------------------------------------------------------------------- #
# rule: banned APIs
# --------------------------------------------------------------------------- #


def port_modules(repo_root: str) -> List[str]:
    """Every module of the port's package, repo-relative, sorted."""
    out = []
    for base, dirs, files in os.walk(os.path.join(repo_root, PORT_PACKAGE)):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for name in files:
            if name.endswith(".py"):
                out.append(_rel(repo_root, os.path.join(base, name)))
    return sorted(out)


def load_host_fetch_waivers(repo_root: str) -> Dict[str, str]:
    """``{"<file>::<function>": reason}`` of the host fetches the design
    needs (empty when the manifest is absent)."""
    path = os.path.join(repo_root, HOST_FETCH_WAIVERS_PATH)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)["waivers"]


def _imports(nodes) -> Iterable[Tuple[ast.AST, str]]:
    for node in nodes:
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node, a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node, node.module


def _is_banned_port_import(mod: str) -> bool:
    return mod.split(".")[0] in BANNED_PORT_IMPORTS


def _enclosing_functions(tree: ast.Module) -> Dict[int, str]:
    """``{line: innermost function name}`` over every function body."""
    where: Dict[int, str] = {}

    def visit(node, name):
        for child in ast.iter_child_nodes(node):
            inner = name
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                inner = child.name
            if hasattr(child, "lineno") and inner is not None:
                where[child.lineno] = inner
            visit(child, inner)

    visit(tree, None)
    return where


def check_banned_apis(
    repo_root: str,
    jax_free: Optional[Sequence[str]] = None,
    no_device_get: Optional[Sequence[str]] = None,
    torch_free: Optional[Sequence[str]] = None,
    jax_anywhere: Optional[Sequence[str]] = None,
    fetch_waivers: Optional[Dict[str, str]] = None,
) -> List[Finding]:
    """The banned-API rules. Called with no lists, over the port's tree:
    the JAX stack in any port module (``jax_anywhere``, every module of
    the package), module-scope jax in ``JAX_FREE_MODULES``, module-scope
    torch in ``TORCH_FREE_MODULES`` and host fetches in
    ``DEVICE_GET_BANNED_MODULES`` (less the waived functions). Called with
    any list, only the lists given run (the JAX rule's signature: a tree
    checked by the JAX rules gives the same rule ids here)."""
    whole_tree = all(x is None for x in
                     (jax_free, no_device_get, torch_free, jax_anywhere))

    def pick(given, default):
        if given is not None:
            return given
        return default() if whole_tree else ()

    jax_free = pick(jax_free, lambda: JAX_FREE_MODULES)
    no_device_get = pick(no_device_get, lambda: DEVICE_GET_BANNED_MODULES)
    torch_free = pick(torch_free, lambda: TORCH_FREE_MODULES)
    jax_anywhere = pick(jax_anywhere, lambda: port_modules(repo_root))
    if fetch_waivers is None:
        fetch_waivers = load_host_fetch_waivers(repo_root)
    findings: List[Finding] = []
    seen = set()

    def add(rule, rel, line, message, remedy):
        if (rule, rel, line) in seen:
            return
        seen.add((rule, rel, line))
        findings.append(Finding(rule=rule, file=rel, line=line,
                                message=message, remedy=remedy))

    for rel in jax_anywhere:
        path = os.path.join(repo_root, rel)
        if not os.path.exists(path):
            continue
        for node, mod in _imports(ast.walk(_parse(path))):
            if _is_banned_port_import(mod):
                add("banned-jax-import", rel, node.lineno,
                    f"import of {mod!r} in a module of the port — the "
                    f"port runs on PyTorch alone and must never load the "
                    f"JAX stack or the JAX package (stoke_tpu imports jax "
                    f"at its root)",
                    "keep a copy of what the port needs in the port "
                    "(as analysis/invariants.py and autotune.py do), or "
                    "move the comparison into a tests/test_torch_*.py "
                    "file, the only place both packages meet; run "
                    "jax-dependent work in a subprocess")
    for rel in jax_free:
        path = os.path.join(repo_root, rel)
        if not os.path.exists(path):
            continue
        for node, mod in _imports(_module_scope_walk(_parse(path))):
            if mod.split(".")[0] in ("jax", "jaxlib"):
                add("banned-jax-import", rel, node.lineno,
                    f"module-scope import of {mod!r} in a jax-free module "
                    f"— a wedged accelerator runtime hangs this process "
                    f"at backend init, and the driver contract is that it "
                    f"never pays that risk",
                    "move the import inside the function that needs it, "
                    "or run the jax-dependent work in a subprocess (the "
                    "scripts/autotune_torch.py discipline)")
    for rel in torch_free:
        path = os.path.join(repo_root, rel)
        if not os.path.exists(path):
            continue
        for node, mod in _imports(_module_scope_walk(_parse(path))):
            if mod.split(".")[0] == "torch":
                add("banned-torch-import", rel, node.lineno,
                    f"module-scope import of {mod!r} in a torch-free "
                    f"module — it is loaded by file before any backend "
                    f"exists (the lint CLI, the autotune driver's "
                    f"parent), and a CUDA initialisation there would pin "
                    f"a card the trials need",
                    "move the import inside the function that needs it, "
                    "or run the torch work in a subprocess (one a trial, "
                    "as scripts/autotune_torch.py does)")
    for rel in no_device_get:
        path = os.path.join(repo_root, rel)
        if not os.path.exists(path):
            continue
        tree = _parse(path)
        where = _enclosing_functions(tree)
        for node in ast.walk(tree):
            hit = (
                isinstance(node, ast.Attribute)
                and node.attr in HOST_FETCH_ATTRS
            ) or (isinstance(node, ast.Name) and node.id == "device_get")
            if not hit:
                continue
            fn = where.get(node.lineno)
            if f"{rel}::{fn}" in fetch_waivers:
                continue
            what = node.attr if isinstance(node, ast.Attribute) else node.id
            add("banned-device-get", rel, node.lineno,
                f"{what} in an engine step path — a synchronous "
                f"per-dispatch host fetch breaks the zero-extra-dispatch "
                f"sentinel discipline and stalls the host until the card "
                f"drains (a captured window cannot hold it at all)",
                "compute the value on the device and read it with the "
                "sentinel row / telemetry cadence; a fetch the design "
                "needs goes into analysis/manifests/host_fetch_waivers"
                ".json under its function, with the reason")
    return findings


# --------------------------------------------------------------------------- #
# the full lint
# --------------------------------------------------------------------------- #


def run_invariant_lints(repo_root: str) -> List[Finding]:
    """Run every torch-free rule over the port's tree; [] on a clean tree
    (the contract ``scripts/stoke_lint_torch.py`` enforces)."""
    findings: List[Finding] = []
    findings += check_wire_formats(repo_root)
    findings += check_config_coverage(repo_root)
    findings += check_jsonl_schema(repo_root)
    findings += check_banned_apis(repo_root)
    return findings
