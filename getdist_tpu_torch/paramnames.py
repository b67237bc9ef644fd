"""Parameter names (host-side, pure Python).

The port's own copy of the parts of ``getdist_tpu/paramnames.py`` that an
``MCSamples`` built from arrays uses: :class:`ParamInfo` and an ordered
name list set from name entries or a count. Each entry is
``name[*] [latex label] [#comment]`` where a trailing ``*`` on the name
marks a derived parameter and ``!`` in labels stands for a backslash.
Loading ``.paramnames`` or Cobaya files, renames and the label helpers are
not ported yet (ROADMAP A10).
"""

__all__ = ["ParamInfo", "ParamNames"]


class ParamInfo:
    """Metadata for one parameter: name tag, latex label, derived and
    periodic flags (reference ``paramnames.py:69-147``)."""

    periodic = False

    def __init__(self, line=None, name="", label="", comment="", derived=False, number=None):
        self.number = number
        self.isDerived = derived
        self.comment = comment
        self.label = label if label else name
        self.setName(name)
        if line is not None:
            self.setFromString(line)

    def setFromString(self, line):
        parts = line.split(None, 1)
        name = parts[0]
        if name.endswith("*"):
            self.isDerived = True
            name = name.rstrip("*")
        self.setName(name)
        if len(parts) > 1:
            label, _, comment = parts[1].partition("#")
            self.label = label.strip().replace("!", "\\")
            self.comment = comment.strip()
        return self

    def setName(self, name):
        if not isinstance(name, str):
            raise ValueError(f"parameter name must be a string, got {type(name)}: {name}")
        if any(ch in name for ch in "*? \t"):
            raise ValueError(r"spaces, * and ? are not allowed in parameter names")
        self.name = name


class ParamNames:
    """Ordered list of :class:`ParamInfo` (reference ``paramnames.py:156-470``)."""

    def __init__(self, default=0, names=None):
        self.names = []
        if default:
            self.setDefault(default)
        if names is not None:
            self.setWithNames(names)

    def name(self, ix):
        return self.names[ix].name

    def setDefault(self, n):
        self.names = [ParamInfo(name="param%d" % ix, label="p_{%i}" % ix) for ix in range(1, n + 1)]
        return self

    def setWithNames(self, names):
        self.names = [ParamInfo(tag) for tag in names]
        return self

    def setLabels(self, labels):
        for info, label in zip(self.names, labels):
            info.label = label

    def deleteIndices(self, indices):
        drop = set(indices)
        self.names = [info for i, info in enumerate(self.names) if i not in drop]
