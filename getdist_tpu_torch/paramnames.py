"""Parameter name/label metadata (host-side, pure Python).

The port's own copy of ``getdist_tpu/paramnames.py``: the ``.paramnames``
text format and the ParamInfo / ParamList / ParamNames API of the
reference (``getdist/paramnames.py``). Each line is ``name[*] [latex
label] [#comment]`` where a trailing ``*`` on the name marks a derived
parameter and ``!`` in labels stands for a backslash; renames (aliases),
labels, derived parameters, filtered copies and text output; and the
parameter block of a Cobaya ``.yaml`` info file (sampled parameters, then
derived ones; the raw info is kept as ``info_dict``).
"""

import fnmatch
import os

__all__ = ["ParamInfo", "ParamList", "ParamNames", "makeList", "mergeRenames", "escapeLatex"]


def makeList(obj):
    """Wrap a scalar in a list; pass lists/tuples through."""
    return obj if isinstance(obj, (list, tuple)) else [obj]


def _require_name_str(name):
    if not isinstance(name, str):
        raise ValueError(f"parameter name must be a string, got {type(name)}: {name}")


def escapeLatex(text):
    """Escape underscores when matplotlib is in usetex mode (cf. reference
    ``paramnames.py:20-26``)."""
    if not text:
        return text
    import matplotlib as mpl

    usetex = mpl.rcParams["text.usetex"]
    return text.replace("_", "{\\textunderscore}") if usetex else text


def mergeRenames(*dicts, keep_names_1st=False):
    """Merge several rename dictionaries into one.

    Each dict maps name -> alias(es). Names connected through any chain of
    aliases end up in one group (union-find over alias sets, as reference
    ``paramnames.py:29-66``); the key for each merged group is taken from the
    left-most dict that mentions it. With ``keep_names_1st`` groups whose only
    member is the first dict's key are kept (empty rename lists preserved).
    """
    groups = [set([key]) | set(makeList(val or [])) for d in dicts for key, val in d.items()]
    merged_groups = []
    while groups:
        current = groups.pop(0)
        changed = True
        while changed:
            changed = False
            for other in list(groups):
                if current & other:
                    current |= other
                    groups.remove(other)
                    changed = True
        merged_groups.append(current)
    result = {}
    for group in merged_groups:
        for d in dicts:
            own = set(d) & group
            if own and (group != own or keep_names_1st):
                key = own.pop()
                rest = set(group)
                rest.remove(key)
                result[key] = list(rest)
                break
    return result


class ParamInfo:
    """Metadata for one parameter: name tag, latex label, derived flag,
    optional aliases (renames) and periodic flag.

    Parses/serializes the ``.paramnames`` line format of the reference
    (``paramnames.py:69-147``).
    """

    # class-level defaults double as pickle back-compat for old objects
    filenameLoadedFrom = ""
    periodic = False

    def __init__(self, line=None, name="", label="", comment="", derived=False, renames=None, number=None):
        self.number = number
        self.renames = makeList(renames) if renames else []
        self.isDerived = derived
        self.comment = comment
        self.label = label if label else name
        self.setName(name)
        if line is not None:
            self.setFromString(line)

    # -- serialization: the line format is the core contract ------------------

    def string(self, wantComments=True):
        tag = f"{self.name}*" if self.isDerived else self.name
        out = f"{tag}\t{self.label}"
        if wantComments and self.comment:
            out = f"{out}\t#{self.comment}"
        return out

    __str__ = string

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

    # -- identity --------------------------------------------------------------

    def setName(self, name):
        _require_name_str(name)
        if any(ch in name for ch in "*? \t"):
            raise ValueError(r"spaces, * and ? are not allowed in parameter names")
        self.name = name

    def nameEquals(self, name):
        """True when ``name`` (a string or ParamInfo) names this parameter.
        (The reference's version compares its argument to itself,
        ``paramnames.py:91-95``; this implements the evident intent.)"""
        other = name.name if isinstance(name, ParamInfo) else name
        return other == self.name

    def getLabel(self):
        return self.label or self.name

    def latexLabel(self):
        return f"${self.label}$" if self.label else self.name

    def __setstate__(self, state):
        # backward-compatible unpickling for objects predating new fields
        state.setdefault("renames", [])
        self.__dict__.update(state)


class ParamList:
    """Ordered collection of :class:`ParamInfo`, with name lookup, glob
    matching, rename handling, and text serialization (reference
    ``paramnames.py:156-416``)."""

    info_dict = None  # raw Cobaya yaml info, when loaded from a .yaml

    def __init__(self, fileName=None, setParamNameFile=None, default=0, names=None, labels=None):
        self.names = []
        if default:
            self.setDefault(default)
        for value, apply in (
            (names, self.setWithNames),
            (fileName, self.loadFromFile),
            (setParamNameFile, self.setLabelsFromParamNames),
            (labels, self.setLabels),
        ):
            if value is not None:
                apply(value)

    # -- lookup (most-used surface) -------------------------------------------

    def parWithName(self, name, error=False, renames=None):
        """Find the :class:`ParamInfo` with the given name, honoring each
        parameter's stored aliases plus an optional extra rename dict."""
        _require_name_str(name)
        aliases = {name}
        if renames:
            aliases.update(makeList(renames.get(name, [])))
        for info in self.names:
            candidates = {info.name, *makeList(getattr(info, "renames", []))}
            if renames:
                candidates.update(makeList(renames.get(info.name, [])))
            if candidates & aliases:
                return info
        if error:
            raise Exception(f"parameter name not found: {name}")
        return None

    def parWithNumber(self, num):
        for info in self.names:
            if info.number == num:
                return info
        return None

    def numberOfName(self, name):
        """Index of the parameter with exactly this name, or -1."""
        _require_name_str(name)
        return next((i for i, info in enumerate(self.names) if info.name == name), -1)

    def hasParam(self, name):
        return self.numberOfName(name) >= 0

    def getMatches(self, pattern, strings=False):
        matched = [info for info in self.names if fnmatch.fnmatchcase(info.name, pattern)]
        return [info.name for info in matched] if strings else matched

    def parsWithNames(self, names, error=False, renames=None):
        """Resolve a list of name strings (globs expand to all matches) to
        :class:`ParamInfo` objects; ``error`` may be a bool or list of bools."""
        names = [names] if isinstance(names, str) else names
        errors = makeList(error)
        if len(errors) < len(names):
            errors = errors * len(names)
        out = []
        for name, err in zip(names, errors):
            if isinstance(name, ParamInfo):
                out.append(name)
            elif "?" in name or "*" in name:
                out.extend(self.getMatches(name))
            else:
                out.append(self.parWithName(name, err, renames))
        return out

    # -- rename handling --------------------------------------------------------

    def getRenames(self, keep_empty=False):
        """Dict of name -> alias list for parameters that have aliases."""
        return {
            info.name: getattr(info, "renames", [])
            for info in self.names
            if getattr(info, "renames", None) or keep_empty
        }

    def updateRenames(self, renames):
        """Fold a rename dict into each parameter's stored aliases."""
        own = self.getRenames(keep_empty=True)
        merged = mergeRenames(own, renames, keep_names_1st=True)
        known = set(self.list())
        for name, aliases in merged.items():
            if name in known:
                self.parWithName(name).renames = aliases

    # -- whole-list views ---------------------------------------------------------

    def list(self):
        """List of parameter name strings."""
        return [info.name for info in self.names]

    def labels(self):
        """List of parameter label strings."""
        return [info.label for info in self.names]

    def listString(self):
        parts = self.list()
        return " ".join(parts)

    def numParams(self):
        return len(self.names)

    def numDerived(self):
        return sum(info.isDerived for info in self.names)

    def numNonDerived(self):
        return sum(not info.isDerived for info in self.names)

    def getDerivedNames(self):
        """Names of all derived parameters."""
        return [info.name for info in self.names if info.isDerived]

    def getRunningNames(self):
        """Names of all sampled (non-derived) parameters."""
        return [info.name for info in self.names if not info.isDerived]

    # -- construction & mutation ------------------------------------------------------

    def loadFromFile(self, fileName):  # pragma: no cover - overridden in ParamNames
        raise NotImplementedError

    def setDefault(self, n):
        self.names = [ParamInfo(name="param%d" % ix, label="p_{%i}" % ix) for ix in range(1, n + 1)]
        return self

    def setWithNames(self, names):
        self.names = [ParamInfo(tag) for tag in names]
        return self

    def setLabels(self, labels):
        for info, label in zip(self.names, labels):
            info.label = label

    def setLabelsFromParamNames(self, fname):
        self.setLabelsAndDerivedFromParamNames(fname, set_derived=False)

    def setLabelsAndDerivedFromParamNames(self, fname, set_derived=True):
        source = fname if isinstance(fname, ParamNames) else ParamNames(fname)
        for other in source.names:
            mine = self.parWithName(other.name)
            if mine is not None:
                mine.label = other.label
                if set_derived:
                    mine.isDerived = other.isDerived

    def deleteIndices(self, indices):
        drop = set(indices)
        self.names = [info for i, info in enumerate(self.names) if i not in drop]

    def filteredCopy(self, params):
        kept = self.__class__()
        for info in self.names:
            wanted = info.name in params if isinstance(params, list) else params.parWithName(info.name)
            if wanted:
                kept.names.append(info)
        return kept

    def addDerived(self, name, **kwargs):
        """Append a new (by default derived) parameter and return its info."""
        if kwargs.get("derived") is None:
            kwargs["derived"] = True
        _require_name_str(name)
        kwargs.pop("name", None)
        self.names.append(ParamInfo(name=name, **kwargs))
        return self.names[-1]

    # -- text output -------------------------------------------------------------------

    def maxNameLen(self):
        return max(len(info.name) for info in self.names)

    def parFormat(self):
        width = max(9, self.maxNameLen()) + 1
        return f"%-{width}s"

    def name(self, ix, tag_derived=False):
        info = self.names[ix]
        return info.name + "*" if tag_derived and info.isDerived else info.name

    def __str__(self):
        return "".join(info.string() + "\n" for info in self.names)

    def saveAsText(self, filename):
        """Write a plain-text ``.paramnames`` file."""
        with open(filename, "w", encoding="utf-8") as handle:
            handle.write(str(self))

    def fileList(self, fname):
        with open(fname, encoding="utf-8-sig") as handle:
            return list(handle)


class ParamNames(ParamList):
    """A :class:`ParamList` loadable from ``.paramnames`` text files or
    Cobaya ``.yaml`` info files (reference ``paramnames.py:419-470``)."""

    def loadFromFile(self, fileName):
        """Load names from a ``.paramnames`` file or a Cobaya "full" yaml."""
        self.filenameLoadedFrom = os.path.basename(fileName)
        ext = os.path.splitext(fileName)[-1].lower()
        if ext == ".paramnames":
            with open(fileName, encoding="utf-8-sig") as handle:
                self.names = [ParamInfo(line) for line in (s.strip() for s in handle) if line]
        elif ext in (".yaml", ".yml"):
            from getdist_tpu_torch import cobaya_interface as cobaya
            from getdist_tpu_torch import yaml_tools

            self.info_dict = yaml_tools.yaml_load_file(fileName)
            info_params = cobaya.get_info_params(self.info_dict)

            def entries(pred, derived):
                for p, info in info_params.items():
                    if pred(info):
                        detail = info or {}
                        yield ParamInfo(
                            name=p,
                            label=detail.get(cobaya._p_label, p),
                            renames=detail.get(cobaya._p_renames),
                            derived=derived,
                        )

            # sampled parameters first, then derived
            self.names = [*entries(cobaya.is_sampled_param, False), *entries(cobaya.is_derived_param, True)]
        else:
            raise ValueError(f"ParamNames must load from .paramnames or .yaml/.yml, got {fileName}")
