"""Qt syntax highlighter for the GUI's generated-script pane (the port's
own copy of ``getdist_tpu/gui/SyntaxHighlight.py``, role of reference
``gui/SyntaxHighlight.py``). Requires PySide6 at class-use time; the rule
tables are plain data so they are testable without Qt.

Covers keywords, builtins, ``self``/``cls``, def/class names, decorators,
numbers (int/float/hex/scientific), single/double/raw strings, f-string
braces, comments, operators, and multi-line triple-quoted strings via
block-state tracking.
"""

KEYWORDS = (
    "and as assert async await break class continue def del elif else except "
    "finally for from global if import in is lambda nonlocal not or pass "
    "raise return try while with yield"
).split()

CONSTANTS = "True False None NotImplemented Ellipsis".split()

BUILTINS = (
    "abs all any bool bytes callable chr classmethod dict dir divmod enumerate "
    "eval exec filter float format frozenset getattr globals hasattr hash hex "
    "id input int isinstance issubclass iter len list locals map max min next "
    "object oct open ord pow print property range repr reversed round set "
    "setattr slice sorted staticmethod str sum super tuple type vars zip"
).split()

# (name, regex, style key) applied in order; style keys map to formats below
RULES = [
    ("keyword", r"\b(?:%s)\b" % "|".join(KEYWORDS), "keyword"),
    ("constant", r"\b(?:%s)\b" % "|".join(CONSTANTS), "constant"),
    ("builtin", r"\b(?:%s)\b(?=\s*\()" % "|".join(BUILTINS), "builtin"),
    ("selfcls", r"\b(?:self|cls)\b", "selfcls"),
    ("defname", r"\bdef\s+(\w+)", "defname"),
    ("classname", r"\bclass\s+(\w+)", "defname"),
    ("decorator", r"@[A-Za-z_][\w.]*", "decorator"),
    ("number", r"\b0[xX][0-9a-fA-F]+\b|\b\d+\.?\d*(?:[eE][+-]?\d+)?\b|\B\.\d+\b", "number"),
    ("string1", r"[rRbBfFuU]{0,2}'(?:[^'\\]|\\.)*'", "string"),
    ("string2", r'[rRbBfFuU]{0,2}"(?:[^"\\]|\\.)*"', "string"),
    ("operator", r"[+\-*/%=<>!&|^~]+", "operator"),
    ("comment", r"#[^\n]*", "comment"),
]

TRIPLE_DELIMS = ("'''", '"""')

STYLES = {
    "keyword": dict(color="#0000a0", bold=True),
    "constant": dict(color="#0000a0", bold=True),
    "builtin": dict(color="#600090"),
    "selfcls": dict(color="#900090", italic=True),
    "defname": dict(color="#007070", bold=True),
    "decorator": dict(color="#805000"),
    "number": dict(color="#905000"),
    "string": dict(color="#007000"),
    "operator": dict(color="#303030"),
    "comment": dict(color="#808080", italic=True),
}


def _make_formats():
    from PySide6.QtGui import QColor, QFont, QTextCharFormat

    formats = {}
    for key, spec in STYLES.items():
        fmt = QTextCharFormat()
        fmt.setForeground(QColor(spec["color"]))
        if spec.get("bold"):
            fmt.setFontWeight(QFont.Bold)
        if spec.get("italic"):
            fmt.setFontItalic(True)
        formats[key] = fmt
    return formats


def _import_qt_base():
    from PySide6.QtGui import QSyntaxHighlighter

    return QSyntaxHighlighter


try:
    _QtBase = _import_qt_base()
except ImportError:  # pragma: no cover - environment without Qt
    _QtBase = object


class PythonHighlighter(_QtBase):
    """Regex-table python highlighting with multi-line string state."""

    IN_TRIPLE = {delim: i + 1 for i, delim in enumerate(TRIPLE_DELIMS)}

    def __init__(self, document):
        super().__init__(document)
        from PySide6.QtCore import QRegularExpression

        self._formats = _make_formats()
        self.rules = [(QRegularExpression(rx), self._formats[style]) for _, rx, style in RULES]
        self._triple = [(QRegularExpression(QRegularExpression.escape(d)), d) for d in TRIPLE_DELIMS]

    def highlightBlock(self, text):
        for pattern, fmt in self.rules:
            it = pattern.globalMatch(text)
            while it.hasNext():
                match = it.next()
                # def/class rules color only the captured name
                group = 1 if match.lastCapturedIndex() >= 1 else 0
                self.setFormat(match.capturedStart(group), match.capturedLength(group), fmt)
        self._highlight_multiline(text)

    def _highlight_multiline(self, text):
        string_fmt = self._formats["string"]
        prev = self.previousBlockState()
        start = 0
        state = 0
        if prev in self.IN_TRIPLE.values():
            delim = TRIPLE_DELIMS[prev - 1]
            end = text.find(delim)
            if end < 0:
                self.setFormat(0, len(text), string_fmt)
                self.setCurrentBlockState(prev)
                return
            self.setFormat(0, end + len(delim), string_fmt)
            start = end + len(delim)
        pos = start
        while True:
            opens = [(text.find(d, pos), d) for d in TRIPLE_DELIMS]
            opens = [(i, d) for i, d in opens if i >= 0]
            if not opens:
                break
            i, delim = min(opens)
            end = text.find(delim, i + len(delim))
            if end < 0:
                self.setFormat(i, len(text) - i, string_fmt)
                state = self.IN_TRIPLE[delim]
                break
            self.setFormat(i, end - i + len(delim), string_fmt)
            pos = end + len(delim)
        self.setCurrentBlockState(state)
