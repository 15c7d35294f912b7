"""docs/api.md cannot rot: every documented symbol must exist.

The reference markets its API through rustdoc, which is checked by the
compiler; this is the moral equivalent for the hand-written reference
doc. Parser contract (kept deliberately simple): a ``## `module```
heading opens a section; within it, every list item starting ``- `name```
contributes (a) its FIRST backticked span and (b) any later span that
contains a call signature ``name(...)`` — each resolved as an attribute
of the section's module. Bare mid-line spans are prose and are skipped.
"""

import importlib
import os
import re

import jax

jax.config.update("jax_platforms", "cpu")

_DOC = os.path.join(os.path.dirname(__file__), "..", "docs", "api.md")
_IDENT = re.compile(r"^[A-Za-z_]\w*$")


def _documented_symbols():
    module = None
    out = []
    for line in open(_DOC):
        h = re.match(r"^## `([\w.]+)`", line)
        if h:
            module = h.group(1)
            continue
        if module is None or not line.startswith("- `"):
            continue
        spans = re.findall(r"`([^`]+)`", line)
        for pos, span in enumerate(spans):
            name = span.split("(")[0]
            if not _IDENT.match(name):
                continue
            if pos == 0 or "(" in span:
                out.append((module, name))
    return out


def test_api_doc_names_exist():
    symbols = _documented_symbols()
    # structure sanity: the doc has many sections and entries
    assert len({m for m, _ in symbols}) >= 8, symbols
    assert len(symbols) >= 60, len(symbols)
    missing = []
    for module, name in symbols:
        mod = importlib.import_module(module)
        if not hasattr(mod, name):
            missing.append(f"{module}.{name}")
    assert not missing, f"documented but nonexistent: {missing}"


def _documented_entries():
    """Yield ``(module, item_text)`` with list items JOINED across their
    indented continuation lines (the per-line parser above only sees
    spans that close on their first line; signatures usually wrap)."""
    module, item, out = None, None, []

    def flush():
        if module is not None and item:
            out.append((module, " ".join(item)))

    for line in open(_DOC):
        h = re.match(r"^## `([\w.]+)`", line)
        if h:
            flush()
            module, item = h.group(1), None
            continue
        if line.startswith("- "):
            flush()
            item = [line[2:].strip()]
        elif item is not None and line.startswith("  ") and line.strip():
            item.append(line.strip())
        else:
            flush()
            item = None
    flush()
    return out


def _split_top_level(s):
    """Split a parameter list on top-level commas."""
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if "".join(cur).strip():
        parts.append("".join(cur))
    return [p.strip() for p in parts]


def _doc_params(span):
    """``name(a, b=1, *, c=None)`` -> [("a", None), ("b", "1"), ...]."""
    inner = span[span.index("(") + 1 : span.rindex(")")]
    params = []
    for p in _split_top_level(inner):
        if p in ("*", "...", "**kwargs", "*args") or not p:
            continue
        name, _, default = p.partition("=")
        name = name.strip().lstrip("*")
        if _IDENT.match(name):
            params.append((name, default.strip() or None))
    return params


def _check_signature(qualname, obj, span, problems):
    import ast
    import inspect

    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):  # pragma: no cover — builtins etc.
        return
    real = {
        n: p for n, p in sig.parameters.items()
        if n != "self" and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
    }
    real_order = list(real)
    last_idx = -1
    for name, doc_default in _doc_params(span):
        if name not in real:
            problems.append(
                f"{qualname}: documented parameter {name!r} does not exist "
                f"(actual: {real_order})"
            )
            continue
        idx = real_order.index(name)
        if idx < last_idx:
            problems.append(
                f"{qualname}: documented parameter order puts {name!r} "
                f"after later parameters (actual order: {real_order})"
            )
        last_idx = max(last_idx, idx)
        p = real[name]
        if doc_default == "...":  # explicit "there is a default" marker
            continue
        if doc_default is not None:
            if p.default is inspect.Parameter.empty:
                problems.append(
                    f"{qualname}: doc shows default {name}={doc_default} "
                    "but the parameter is required"
                )
            else:
                try:
                    doc_val = ast.literal_eval(doc_default)
                except (ValueError, SyntaxError):
                    continue  # non-literal doc default: existence is enough
                same = doc_val == p.default or (
                    isinstance(doc_val, (int, float))
                    and isinstance(p.default, (int, float))
                    and float(doc_val) == float(p.default)
                )
                if not same:
                    problems.append(
                        f"{qualname}: doc default {name}={doc_default!r} "
                        f"!= actual {p.default!r}"
                    )
        elif p.default is not inspect.Parameter.empty and doc_default is None:
            # documented as required but actually optional: harmless
            pass


def test_api_doc_signatures_match():
    """Every documented call signature — the entry's own and any
    backticked ``.method(...)`` spans inside it — must agree with
    ``inspect.signature``: parameter names exist, relative order holds,
    and literal defaults match (a renamed kwarg or a
    changed default must fail the suite, not rot silently)."""
    problems = []
    n_checked = 0
    for module, item in _documented_entries():
        spans = re.findall(r"`([^`]+)`", item)
        if not spans:
            continue
        first = spans[0]
        name = first.split("(")[0].strip()
        if not _IDENT.match(name):
            continue
        mod = importlib.import_module(module)
        obj = getattr(mod, name, None)
        if obj is None:
            continue  # existence is test_api_doc_names_exist's job
        if "(" in first and ")" in first:
            _check_signature(f"{module}.{name}", obj, first, problems)
            n_checked += 1
        for span in spans[1:]:
            m = re.match(r"^\.(\w+)\(", span)
            if m and ")" in span:
                meth = getattr(obj, m.group(1), None)
                if meth is not None:
                    _check_signature(
                        f"{module}.{name}.{m.group(1)}", meth, span,
                        problems,
                    )
                    n_checked += 1
                continue
            # sibling symbols documented inside the same item, e.g.
            # `save_csv_tensor(sample, path)` under the save_csv entry
            m = re.match(r"^(\w+)\(", span)
            if m and ")" in span:
                sib = getattr(mod, m.group(1), None)
                if sib is not None:
                    _check_signature(
                        f"{module}.{m.group(1)}", sib, span, problems
                    )
                    n_checked += 1
    assert n_checked >= 40, f"parser found only {n_checked} signatures"
    assert not problems, "\n".join(problems)


def test_api_doc_covers_public_root():
    """Everything in the package's __all__ appears as a token inside
    SOME backticked span of the doc — plain-prose substring matches
    (e.g. 'io' inside 'observation') do not count."""
    import mini_mcmc_tpu as mm

    text = open(_DOC).read()
    tokens = {
        word
        for span in re.findall(r"`([^`]+)`", text)
        for word in re.findall(r"[A-Za-z_]\w*", span)
    }
    missing = [n for n in mm.__all__ if n not in tokens]
    assert not missing, f"public but undocumented: {missing}"
