"""Reader and printer for the markup the HTML exporter writes.

``pretty_print(markup)`` returns, byte for byte, what

    etree.tostring(lxml.html.fromstring(markup), pretty_print=True,
                   encoding="unicode")

returns for it (libxml2's HTML parser, lxml's fragment rule and libxml2's
XML serialiser): the JAX package's HTML output.  It reads only the closed
set the exporter emits: the tags ``p``, ``h1``, ``br``, ``table``, ``tr``,
``td`` and ``img``, written in lower case with double-quoted attributes;
text with the entities ``html.escape`` writes; character references in an
attribute value as HTML5 reads them (a figure's path is written
unescaped), numeric ones excepted.  Anything else raises ValueError: it is
no general HTML parser.

What it reproduces:

* libxml2's tree.  A start tag first closes the open elements it ends,
  innermost first (``p`` ends at p, h1, table, tr and td; ``h1`` at p and
  table; ``tr`` at tr; ``td`` at tr and td); ``br`` and ``img`` hold
  nothing.  An end tag closes its element and everything opened inside
  it, unless one of those outranks it (td < tr < table; p and h1 rank
  below td), and is dropped where its element is not open.  So
  ``<p><h1>x</h1></p>`` reads as an empty ``p`` with the ``h1`` beside it,
  and the ``</p>`` is dropped.
* lxml's fragment rule: one top-level element comes back alone; several
  are wrapped in a ``div`` where any of them is or holds one of lxml's
  block tags (p, h1, table, tr, td here), else in a ``span``.
* libxml2's serialiser: an element with no content closes itself
  (``<br/>``, ``<p/>``); one whose content is all elements is broken over
  lines, two spaces a level; one with any text (a single space counts)
  stays on one line with everything it holds.  Text escapes ``&``, ``<``
  and ``>``; attribute values also tab, newline and carriage return.  The
  output ends with a newline.
"""

import re
from html.entities import html5

#: tags the exporter writes, and the void ones among them
TAGS = frozenset({"p", "h1", "br", "table", "tr", "td", "img"})
VOID = frozenset({"br", "img"})
#: open element -> the start tags that close it (libxml2's htmlStartClose,
#: restricted to TAGS)
CLOSED_BY = {
    "p": frozenset({"p", "h1", "table", "tr", "td"}),
    "h1": frozenset({"p", "table"}),
    "tr": frozenset({"tr"}),
    "td": frozenset({"tr", "td"}),
}
#: an end tag closes no open element that outranks it (libxml2's
#: htmlEndPriority; everything else ranks 100)
END_PRIORITY = {"td": 160, "tr": 170, "table": 190}
#: lxml.html's block tags among TAGS: several top-level elements that hold
#: one are wrapped in a div, else in a span
BLOCK = frozenset({"p", "h1", "table", "tr", "td"})
#: libxml2 indents at most this many levels
MAX_INDENT = 30
#: deeper nesting raises: the exporter nests four deep, and libxml2 drops
#: elements past about 250 levels
MAX_DEPTH = 100

_TEXT_ENTITIES = {"amp": "&", "lt": "<", "gt": ">", "quot": '"', "#x27": "'"}
_TOKEN = re.compile(
    r'<(?P<start>[a-z0-9]+)(?P<attrs>(?: [a-z]+="[^"]*")*)>'
    r"|</(?P<end>[a-z0-9]+)>"
    r"|(?P<text>[^<&]+)"
    r"|&(?P<entity>amp|lt|gt|quot|#x27);"
)
_ATTR = re.compile(r' ([a-z]+)="([^"]*)"')
#: C0 controls but tab and line feed (libxml2 rewrites them)
_CONTROL = re.compile(r"[\x00-\x08\x0b-\x1f]")
_NAME = re.compile(r"[A-Za-z0-9]+")
_TEXT_ESCAPES = str.maketrans({"&": "&amp;", "<": "&lt;", ">": "&gt;"})
_ATTR_ESCAPES = str.maketrans({"&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;",
                               "\t": "&#9;", "\n": "&#10;", "\r": "&#13;"})


class Element:
    __slots__ = ("tag", "attrs", "children")

    def __init__(self, tag, attrs=(), children=None):
        self.tag = tag
        self.attrs = list(attrs)
        self.children = [] if children is None else children  # Element or str

    def iter(self):
        yield self
        for child in self.children:
            if isinstance(child, Element):
                yield from child.iter()


def _outside(what, markup, pos):
    raise ValueError(f"{what} at offset {pos}, outside the exporter's markup: "
                     f"{markup[max(pos - 20, 0):pos + 20]!r}")


def attribute_value(raw):
    """An attribute value as HTML5 reads it: a named character reference
    decodes where the longest entity name it starts with ends in ``;`` or
    is followed by neither an ASCII letter or digit nor ``=``; any other
    ``&`` stays as it is.  A numeric reference raises."""
    out, i = [], 0
    while (amp := raw.find("&", i)) >= 0:
        out.append(raw[i:amp])
        i = amp + 1
        if raw.startswith("#", i):
            raise ValueError(f"numeric character reference in attribute value {raw!r}")
        name = _NAME.match(raw, i)
        ref = None
        if name:
            tail = raw[i:name.end() + 1]  # the name and the character after it
            for n in range(min(len(tail), 33), 0, -1):
                if tail[:n] in html5:
                    ref = tail[:n]
                    break
        after = raw[i + len(ref)] if ref and i + len(ref) < len(raw) else ""
        if ref is None or (not ref.endswith(";") and (after == "=" or (
                after.isascii() and after.isalnum()))):
            out.append("&")
            continue
        out.append(html5[ref])
        i += len(ref)
    out.append(raw[i:])
    return "".join(out)


def parse(markup):
    """The markup's top-level elements, as libxml2's HTML parser builds
    them -> list of Element."""
    if (bad := _CONTROL.search(markup)) is not None:
        _outside("control character", markup, bad.start())
    body = Element("body")
    stack = [body]
    pos = 0
    while pos < len(markup):
        m = _TOKEN.match(markup, pos)
        if m is None:
            _outside("unknown markup", markup, pos)
        if (tag := m["start"]) is not None:
            if tag not in TAGS:
                _outside(f"tag <{tag}>", markup, pos)
            attrs = _ATTR.findall(m["attrs"])
            if len({k for k, _ in attrs}) != len(attrs):
                _outside("a repeated attribute", markup, pos)
            while len(stack) > 1 and tag in CLOSED_BY.get(stack[-1].tag, ()):
                stack.pop()
            el = Element(tag, [(k, attribute_value(v)) for k, v in attrs])
            stack[-1].children.append(el)
            if tag not in VOID:
                if len(stack) >= MAX_DEPTH:
                    _outside("nesting too deep", markup, pos)
                stack.append(el)
        elif (tag := m["end"]) is not None:
            if tag not in TAGS or tag in VOID:
                _outside(f"end tag </{tag}>", markup, pos)
            rank = END_PRIORITY.get(tag, 100)
            for i in range(len(stack) - 1, 0, -1):
                if stack[i].tag == tag:
                    del stack[i:]
                    break
                if END_PRIORITY.get(stack[i].tag, 100) > rank:
                    break
        else:
            if len(stack) == 1:
                _outside("text outside an element", markup, pos)
            text = m["text"] if m["entity"] is None else _TEXT_ENTITIES[m["entity"]]
            kids = stack[-1].children
            if kids and isinstance(kids[-1], str):
                kids[-1] += text
            else:
                kids.append(text)
        pos = m.end()
    return body.children


def fragment(markup):
    """lxml.html.fromstring's element for the markup: its one top-level
    element, or all of them in a div (where one holds a block tag) or a
    span."""
    top = parse(markup)
    if not top:
        raise ValueError(f"no element in {markup[:40]!r}")
    if len(top) == 1:
        return top[0]
    wrapper = Element("span", (), top)
    if any(el.tag in BLOCK for el in wrapper.iter()):
        wrapper.tag = "div"
    return wrapper


def _dump(el, out, level, formatted):
    out.append("<" + el.tag)
    for k, v in el.attrs:
        out.append(f' {k}="{v.translate(_ATTR_ESCAPES)}"')
    if not el.children:
        out.append("/>")
        return
    out.append(">")
    if formatted and not any(isinstance(c, str) for c in el.children):
        out.append("\n")
        for child in el.children:
            out.append("  " * min(level + 1, MAX_INDENT))
            _dump(child, out, level + 1, True)
            out.append("\n")
        out.append("  " * min(level, MAX_INDENT))
    else:
        for child in el.children:
            if isinstance(child, str):
                out.append(child.translate(_TEXT_ESCAPES))
            else:
                _dump(child, out, level + 1, False)
    out.append(f"</{el.tag}>")


def serialize(el):
    """libxml2's pretty-printed XML of ``el``, with lxml's closing newline."""
    out = []
    _dump(el, out, 0, True)
    out.append("\n")
    return "".join(out)


def pretty_print(markup):
    """The exporter's markup read and printed as lxml prints it (module
    docstring); raises ValueError on markup outside that set."""
    return serialize(fragment(markup))
