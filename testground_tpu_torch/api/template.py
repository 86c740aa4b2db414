"""Composition templating: a Go text/template subset for composition TOML.

The reference renders composition files through Go's ``text/template`` with a
six-function map before TOML-decoding them (``pkg/cmd/template.go:25-60``;
entry point ``loadComposition`` at ``template.go:88-107``). This module is
the behavioral twin: the same ``{{ ... }}`` action syntax — pipelines,
``with``/``range``/``if`` blocks, ``define``/``template`` partials, ``-``
whitespace-trim markers — and the same function map: ``pick``, ``toml``,
``withEnv``, ``split``, ``atoi``, ``load_resource``, plus the Go builtin
``index``. Python is the host language, so this is a compact recursive
interpreter over the action grammar, not a port of Go's template package;
only the surface real compositions use is implemented (no variable
assignment, no comparison builtins).

Rendering is client-side (CLI loading path), exactly like the reference:
the daemon only ever sees rendered TOML.

The port's own copy of the reference's ``testground_tpu/api/template.py``
(ROADMAP's copy policy); ``tests/test_torch_composition.py`` pins it against
the original.
"""

from __future__ import annotations

import os
import re
import tomllib

from ..utils.toml_writer import dumps as _toml_dumps

__all__ = [
    "TemplateError",
    "compile_composition_template",
    "render_template",
]


class TemplateError(Exception):
    """Parse or evaluation failure inside a composition template."""


_UNSET = object()

_ACTION_RE = re.compile(r"\{\{(-)?((?:[^}]|\}(?!\}))*?)(-)?\}\}", re.DOTALL)

_TOKEN_RE = re.compile(
    r"""
      (?P<ws>\s+)
    | (?P<pipe>\|)
    | (?P<lparen>\()
    | (?P<rparen>\))
    | (?P<string>"(?:[^"\\]|\\.)*"|`[^`]*`)
    | (?P<number>-?\d+(?:\.\d+)?)
    | (?P<var>\$[A-Za-z0-9_.]*)
    | (?P<field>\.[A-Za-z0-9_.]*)
    | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
    """,
    re.VERBOSE,
)


# --------------------------------------------------------------------------
# Lexing: split source into text segments and {{ action }} segments, applying
# the `-` trim markers to adjacent text (text/template semantics).


def _lex(src: str):
    segs = []  # ("text", s) | ["action", content, ltrim, rtrim]
    pos = 0
    for m in _ACTION_RE.finditer(src):
        segs.append(["text", src[pos : m.start()]])
        segs.append(["action", m.group(2).strip(), bool(m.group(1)), bool(m.group(3))])
        pos = m.end()
    segs.append(["text", src[pos:]])
    for i, s in enumerate(segs):
        if s[0] == "action":
            if s[2] and segs[i - 1][0] == "text":
                segs[i - 1][1] = segs[i - 1][1].rstrip()
            if s[3] and i + 1 < len(segs) and segs[i + 1][0] == "text":
                segs[i + 1][1] = segs[i + 1][1].lstrip()
    return segs


# --------------------------------------------------------------------------
# Pipeline parsing. Grammar:  pipeline := cmd ('|' cmd)* ;  cmd := operand+ ;
# operand := field | var | string | number | ident | '(' pipeline ')'


def _tokenize_action(content: str):
    toks, pos = [], 0
    while pos < len(content):
        m = _TOKEN_RE.match(content, pos)
        if m is None:
            raise TemplateError(f"bad token at {content[pos:pos+20]!r}")
        kind = m.lastgroup
        if kind != "ws":
            toks.append((kind, m.group(), pos))
        pos = m.end()
    return toks


def _parse_pipeline(content: str):
    toks = _tokenize_action(content)
    pipe, i = _parse_pipe_toks(toks, 0)
    if i != len(toks):
        raise TemplateError(f"trailing tokens in action: {content!r}")
    return pipe


def _parse_pipe_toks(toks, i):
    cmds = []
    while True:
        cmd, i = _parse_cmd(toks, i)
        cmds.append(cmd)
        if i < len(toks) and toks[i][0] == "pipe":
            i += 1
            continue
        return cmds, i


def _parse_cmd(toks, i):
    operands = []
    while i < len(toks) and toks[i][0] not in ("pipe", "rparen"):
        kind, text = toks[i][0], toks[i][1]
        if kind == "lparen":
            inner, i = _parse_pipe_toks(toks, i + 1)
            if i >= len(toks) or toks[i][0] != "rparen":
                raise TemplateError("missing )")
            node = ("paren", inner)
            rparen_end = toks[i][2] + 1
            i += 1
            # `(expr).field` — a field token adjacent to the closing paren
            # chains onto the expression's result (text/template semantics);
            # a space-separated `.field` is a distinct argument.
            if (
                i < len(toks)
                and toks[i][0] == "field"
                and toks[i][2] == rparen_end
            ):
                parts = [p for p in toks[i][1][1:].split(".") if p]
                node = ("chain", inner, parts)
                i += 1
            operands.append(node)
        elif kind == "string":
            operands.append(("str", _unquote(text)))
            i += 1
        elif kind == "number":
            operands.append(("num", float(text) if "." in text else int(text)))
            i += 1
        elif kind == "field":
            parts = [p for p in text[1:].split(".") if p]
            operands.append(("field", parts))
            i += 1
        elif kind == "var":
            parts = [p for p in text[1:].split(".") if p]
            operands.append(("var", parts))
            i += 1
        else:  # ident → function reference
            operands.append(("fn", text))
            i += 1
    if not operands:
        raise TemplateError("empty command in pipeline")
    return operands, i


def _unquote(text: str) -> str:
    if text.startswith("`"):
        return text[1:-1]
    body = text[1:-1]
    return re.sub(
        r"\\(.)",
        lambda m: {"n": "\n", "t": "\t", "r": "\r"}.get(m.group(1), m.group(1)),
        body,
    )


# --------------------------------------------------------------------------
# Block parsing: text/action segments → node tree + named templates.


def _first_word(content: str) -> str:
    return content.split(None, 1)[0] if content else ""


def _parse(segs):
    templates: dict[str, list] = {}

    def parse_else_tail(j, kind, pipe, body):
        """segs[j] is the `end`/`else`/`else if ...` action closing a block;
        build the node, recursing through `else if` chains. Returns the node
        and the index of the final `end` segment."""
        content = segs[j][1]
        if _first_word(content) == "else":
            rest = content[len("else") :].strip()
            if rest:
                if _first_word(rest) != "if":
                    raise TemplateError(f"expected 'else if', got {content!r}")
                pipe2 = _parse_pipeline(rest[len("if") :].strip())
                body2, j2 = parse_block(j + 1, {"end", "else"})
                inner, j3 = parse_else_tail(j2, "if", pipe2, body2)
                return (kind, pipe, body, [inner]), j3
            else_body, j2 = parse_block(j + 1, {"end"})
            return (kind, pipe, body, else_body), j2
        return (kind, pipe, body, []), j

    def parse_block(i, terminators):
        nodes = []
        while i < len(segs):
            seg = segs[i]
            if seg[0] == "text":
                if seg[1]:
                    nodes.append(("text", seg[1]))
                i += 1
                continue
            content = seg[1]
            if content.startswith("/*"):
                # {{/* comment */}} — consumed, emits nothing.
                if not content.endswith("*/"):
                    raise TemplateError("unclosed template comment")
                i += 1
                continue
            word = _first_word(content)
            if word in terminators:
                return nodes, i
            i += 1
            if word == "define":
                name = _expect_string(content[len("define") :].strip())
                body, j = parse_block(i, {"end"})
                templates[name] = body
                i = j + 1
            elif word in ("with", "range", "if"):
                pipe = _parse_pipeline(content[len(word) :].strip())
                body, j = parse_block(i, {"end", "else"})
                node, j = parse_else_tail(j, word, pipe, body)
                nodes.append(node)
                i = j + 1
            elif word == "template":
                rest = content[len("template") :].strip()
                name, remainder = _scan_string(rest)
                pipe = _parse_pipeline(remainder) if remainder.strip() else None
                nodes.append(("template", name, pipe))
            elif word in ("end", "else"):
                raise TemplateError(f"unexpected {{{{{word}}}}}")
            else:
                nodes.append(("pipe", _parse_pipeline(content)))
        if terminators:
            raise TemplateError(f"unterminated block; expected {terminators}")
        return nodes, i

    nodes, _ = parse_block(0, set())
    return nodes, templates


def _expect_string(text: str) -> str:
    name, rest = _scan_string(text)
    if rest.strip():
        raise TemplateError(f"trailing content after name: {text!r}")
    return name


def _scan_string(text: str):
    toks = _tokenize_action(text)
    if not toks or toks[0][0] != "string":
        raise TemplateError(f"expected quoted name in {text!r}")
    name = _unquote(toks[0][1])
    consumed = text.index(toks[0][1]) + len(toks[0][1])
    return name, text[consumed:]


# --------------------------------------------------------------------------
# Evaluation.


def _field_get(base, parts):
    for p in parts:
        if isinstance(base, dict):
            base = base.get(p)
        elif base is None:
            return None
        else:
            raise TemplateError(f"cannot access field {p!r} on {type(base).__name__}")
    return base


def _eval_operand(op, dot, root, funcs):
    kind = op[0]
    if kind == "str" or kind == "num":
        return op[1]
    if kind == "field":
        return _field_get(dot, op[1])
    if kind == "var":
        return _field_get(root, op[1])
    if kind == "paren":
        return _eval_pipe(op[1], dot, root, funcs)
    if kind == "chain":
        return _field_get(_eval_pipe(op[1], dot, root, funcs), op[2])
    if kind == "fn":
        raise TemplateError(f"function {op[1]!r} used as a value")
    raise TemplateError(f"bad operand {op!r}")


def _eval_cmd(cmd, dot, root, funcs, piped):
    head = cmd[0]
    args = [_eval_operand(a, dot, root, funcs) for a in cmd[1:]]
    if piped is not _UNSET:
        args.append(piped)
    if head[0] == "fn":
        fn = funcs.get(head[1])
        if fn is None:
            raise TemplateError(f"unknown function {head[1]!r}")
        try:
            return fn(*args)
        except TemplateError:
            raise
        except Exception as err:  # atoi/load_resource failures surface as-is
            raise TemplateError(f"{head[1]}: {err}") from err
    value = _eval_operand(head, dot, root, funcs)
    if args:
        raise TemplateError(f"cannot call non-function {head!r} with arguments")
    return value


def _eval_pipe(pipe, dot, root, funcs):
    val = _UNSET
    for cmd in pipe:
        val = _eval_cmd(cmd, dot, root, funcs, val)
    return val


def _to_str(v) -> str:
    if v is None:
        return "<no value>"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return v
    return str(v)


def _exec_nodes(nodes, dot, root, funcs, templates, out):
    for node in nodes:
        kind = node[0]
        if kind == "text":
            out.append(node[1])
        elif kind == "pipe":
            out.append(_to_str(_eval_pipe(node[1], dot, root, funcs)))
        elif kind == "with":
            val = _eval_pipe(node[1], dot, root, funcs)
            if val:
                _exec_nodes(node[2], val, root, funcs, templates, out)
            else:
                _exec_nodes(node[3], dot, root, funcs, templates, out)
        elif kind == "if":
            val = _eval_pipe(node[1], dot, root, funcs)
            branch = node[2] if val else node[3]
            _exec_nodes(branch, dot, root, funcs, templates, out)
        elif kind == "range":
            val = _eval_pipe(node[1], dot, root, funcs)
            items = list(val.values()) if isinstance(val, dict) else (val or [])
            if items:
                for item in items:
                    _exec_nodes(node[2], item, root, funcs, templates, out)
            else:
                _exec_nodes(node[3], dot, root, funcs, templates, out)
        elif kind == "template":
            body = templates.get(node[1])
            if body is None:
                raise TemplateError(f"undefined template {node[1]!r}")
            arg = (
                _eval_pipe(node[2], dot, root, funcs)
                if node[2] is not None
                else None
            )
            # Inside an invoked template both `.` and `$` bind to the argument
            # (text/template semantics).
            _exec_nodes(body, arg, arg, funcs, templates, out)
        else:
            raise TemplateError(f"bad node {kind!r}")


# --------------------------------------------------------------------------
# Function map (template.go:25-60) + the Go builtin `index`.


def _index(collection, *keys):
    for k in keys:
        if isinstance(collection, dict):
            collection = collection.get(k)
        else:
            collection = collection[int(k)]
    return collection


def _make_funcs(template_dir: str, env: dict):
    def load_resource(p):
        # Client-side rendering: like the reference, paths resolve relative to
        # the template's own directory with no sandboxing (template.go:50-52).
        full = os.path.join(template_dir, p)
        with open(full, "rb") as f:
            return tomllib.load(f)

    def with_env(value):
        if not isinstance(value, dict):
            raise TemplateError("withEnv expects a table")
        return {**value, "Env": env}

    def pick(v, key):
        if not isinstance(v, dict):
            raise TemplateError("pick expects a table")
        return {key: v.get(key)}

    return {
        "pick": pick,
        "toml": _toml_dumps,
        "withEnv": with_env,
        "split": lambda s: s.split(","),
        "atoi": lambda s: int(str(s).strip()),
        "load_resource": load_resource,
        "index": _index,
    }


# --------------------------------------------------------------------------
# Public API.


def render_template(text: str, env: dict | None = None, template_dir: str = ".") -> str:
    """Render template ``text`` with ``{"Env": env}`` as the data, matching
    ``compositionData`` (``template.go:17-19``)."""
    env = dict(env) if env is not None else dict(os.environ)
    nodes, templates = _parse(_lex(text))
    data = {"Env": env}
    out: list[str] = []
    _exec_nodes(nodes, data, data, _make_funcs(template_dir, env), templates, out)
    return "".join(out)


def compile_composition_template(path, env: dict | None = None) -> str:
    """Read + render a composition file; the rendered TOML string is what gets
    decoded into a Composition (``template.go:88-107``)."""
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    return render_template(text, env=env, template_dir=os.path.dirname(os.path.abspath(path)))
