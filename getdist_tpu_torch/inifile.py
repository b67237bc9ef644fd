"""Key=value settings files with inheritance (.ini system).

The port's own copy of ``getdist_tpu/inifile.py``. Behavioral spec:
reference ``getdist/inifile.py:10-412``. Supports ``INCLUDE(file)`` /
``DEFAULT(file)`` inheritance, ``$(ENVVAR)`` expansion, typed getters
(bool as T/F, space-separated lists, ndarrays, indexed ``name(i)``
entries), ``setAttr`` reflection that writes typed values onto objects
using the type of the current attribute value, and saving.
"""

import os

import numpy as np

__all__ = ["IniFile", "IniError"]


class IniError(Exception):
    pass


def _bracket_arg(line):
    """The text inside the first (...) group of a directive line."""
    return line[line.find("(") + 1 : line.rfind(")")]


def _ini_text(value):
    """Render a python value the way .ini files expect (bools as T/F)."""
    match value:
        case str():
            return value
        case bool():
            return "T" if value else "F"
        case _:
            return str(value)


def _expand_env(text):
    """Expand $(var) placeholders from the environment ($$ = literal $,
    bare $ dropped, unknown variables expand to nothing)."""
    pieces = []
    cursor = 0
    size = len(text)
    while cursor < size:
        ch = text[cursor]
        if ch != "$":
            pieces.append(ch)
            cursor += 1
            continue
        lookahead = text[cursor + 1] if cursor + 1 < size else ""
        if lookahead == "$":
            pieces.append("$")
            cursor += 2
        elif lookahead == "(":
            close = text.index(")", cursor + 2)
            pieces.append(os.environ.get(text[cursor + 2 : close], ""))
            cursor = close + 1
        else:
            cursor += 1
    return "".join(pieces)


class IniFile:
    """Stores option values; reads/saves .ini files with inheritance.

    Unlike standard .ini files, a file can use INCLUDE(..) and DEFAULT(...)
    to pull in or fall back to settings from another file.

    :ivar params: dictionary of stored name -> value
    :ivar comments: dictionary of optional comments per parameter name
    """

    def __init__(self, settings=None, keep_includes=False, expand_environment_variables=True):
        """
        :param settings: filename of a .ini file to read, or a dict of values
        :param keep_includes:
             - False: load all INCLUDE and DEFAULT files into one params dict
             - True: only load the main file; store INCLUDE/DEFAULT names in
               the includes and defaults lists
        :param expand_environment_variables: expand $(var) placeholders in
               values from the environment
        """
        self.params, self.comments = {}, {}
        self.includes, self.defaults = [], []
        self.readOrder = []
        self.expand_environment_variables = expand_environment_variables
        self.original_filename = None
        if settings is not None:
            if isinstance(settings, str):
                self.readFile(settings, keep_includes)
            else:
                self.params.update(settings)

    # -- presence & typed scalar getters --------------------------------------

    def hasKey(self, name):
        """True when the parameter name exists."""
        return name in self.params

    def isSet(self, name, allowEmpty=False):
        """True when the parameter exists and (unless allowEmpty) is non-empty."""
        if name not in self.params:
            return False
        return allowEmpty or self.params[name] != ""

    def _missing(self, name):
        raise IniError(f"no such .ini parameter: {name}")

    def asType(self, name, tp, default=None, allowEmpty=False):
        if not self.isSet(name, allowEmpty):
            if default is None:
                self._missing(name)
            return default
        # types with bespoke parsing go through their own getter
        bespoke = {bool: self.bool, list: self.split, np.ndarray: self.ndarray}
        handler = bespoke.get(tp)
        return handler(name, default) if handler else tp(self.params[name])

    def bool(self, name, default=False):
        """Boolean value (text starting T = True, F = False)."""
        if not self.isSet(name):
            if default is None:
                self._missing(name)
            return default
        text = self.params[name]
        if isinstance(text, bool):
            return text
        flag = {"T": True, "F": False}.get(text[:1])
        if flag is None:
            raise IniError(f".ini parameter {name} is not a valid T(rue)/F(alse) boolean")
        return flag

    def _scalar(self, tp, name, default, allowEmpty=False):
        return self.asType(name, tp, default, allowEmpty=allowEmpty)

    def string(self, name, default=None, allowEmpty=True):
        """String value."""
        return self._scalar(str, name, default, allowEmpty)

    def float(self, name, default=None):
        """Float value."""
        return self._scalar(float, name, default)

    def int(self, name, default=None):
        """Int value."""
        return self._scalar(int, name, default)

    # -- list-valued getters ---------------------------------------------------

    def split(self, name, default=None, tp=None):
        """List of values from a space-separated entry, optionally cast to tp."""
        cast = (lambda seq: seq) if tp is None else (lambda seq: [tp(x) for x in seq])
        stored = self.params.get(name)
        if isinstance(stored, (list, tuple)):
            return cast(stored)
        text = self.string(name, default)
        return cast(text.split()) if isinstance(text, str) else text

    def list(self, name, default=None, tp=None):
        """List of values (space-separated)."""
        return self.split(name, default or [], tp)

    def bool_list(self, name, default=None):
        """List of booleans, e.g. from ``name = T F T``."""
        return self.split(name, default or [], tp=bool)

    def float_list(self, name, default=None):
        """List of floats."""
        return self.split(name, default or [], tp=float)

    def int_list(self, name, default=None):
        """List of ints."""
        return self.split(name, default or [], tp=int)

    def ndarray(self, name, default=None, tp=np.float64):
        """Numpy array of values."""
        values = self.split(name, default, tp=tp)
        return np.array(values)

    # -- indexed name(i) getters -------------------------------------------------

    def _indexed(self, getter, name, index, default):
        return getter(f"{name}({index:d})", default)

    def array_bool(self, name, index=1, default=None):
        """Bool entry of the indexed form ``name(index)``."""
        return self._indexed(self.bool, name, index, default)

    def array_float(self, name, index=1, default=None):
        """Float entry of the indexed form ``name(index)``."""
        return self._indexed(self.float, name, index, default)

    def array_int(self, name, index=1, default=None):
        """Int entry of the indexed form ``name(index)``."""
        return self._indexed(self.int, name, index, default)

    def array_string(self, name, index=1, default=None):
        """String entry of the indexed form ``name(index)``."""
        return self._indexed(self.string, name, index, default)

    # -- object reflection --------------------------------------------------------

    def setAttr(self, name, instance, default=None, allowEmpty=False):
        """Set instance.name from the parameter, cast to the type of the
        attribute's current (or default) value."""
        current = getattr(instance, name, default)
        typed = self.asType(name, type(current), current, allowEmpty=allowEmpty)
        setattr(instance, name, typed)

    def getAttr(self, instance, name, default=None, comment=None):
        self.params[name] = getattr(instance, name, default)
        if comment:
            self.comments[name] = comment

    # -- bulk edits ------------------------------------------------------------------

    def replaceTags(self, placeholder, text):
        self.params = {key: value.replace(placeholder, text) for key, value in self.params.items()}
        return self.params

    def delete_keys(self, keys):
        for key in keys:
            self.params.pop(key, None)

    # -- file IO -----------------------------------------------------------------------

    def expand_placeholders(self, s):
        """Expand $(var) placeholders (see :func:`_expand_env`)."""
        return _expand_env(s) if "$(" in s else s

    def _store(self, line, filename, if_not_defined, pending_comments):
        if "=" not in line:
            return False
        key, _, raw = line.partition("=")
        key = key.strip()
        if key in self.params:
            if if_not_defined:
                return True
            raise IniError(f"Error: duplicate key: {key} in {filename}")
        raw = raw.strip()
        self.params[key] = self.expand_placeholders(raw) if self.expand_environment_variables else raw
        self.readOrder.append(key)
        if pending_comments:
            self.comments[key] = list(pending_comments)
        return True

    def _parse_stream(self, stream, filename, if_not_defined):
        """Read key=value lines; returns ([included files], [default files])."""
        inherit = {"INCLUDE(": [], "DEFAULT(": []}
        pending_comments = []
        for raw in stream:
            line = raw.strip()
            if line == "END":
                break
            if line.startswith("#"):
                pending_comments.append(line[1:].rstrip())
                continue
            directive = next((d for d in inherit if line.startswith(d)), None)
            if directive:
                inherit[directive].append(_bracket_arg(line))
            elif line:
                self._store(line, filename, if_not_defined, pending_comments)
            pending_comments = []
        return inherit["INCLUDE("], inherit["DEFAULT("]

    def readFile(self, filename, keep_includes=False, if_not_defined=False):
        try:
            self.original_filename = filename
            with open(filename, encoding="utf-8-sig") as stream:
                included, defaulted = self._parse_stream(stream, filename, if_not_defined)
            if keep_includes:
                self.includes += included
                self.defaults += defaulted
            else:
                base_dir = os.path.dirname(filename)

                def resolve(inherited):
                    return inherited if os.path.isabs(inherited) else os.path.join(base_dir, inherited)

                for inherited in included:
                    self.readFile(resolve(inherited), if_not_defined=if_not_defined)
                for inherited in defaulted:
                    self.readFile(resolve(inherited), if_not_defined=True)
            return self.params
        except Exception:
            print(f"Error in {filename}")
            raise

    def saveFile(self, filename=None):
        """Write the settings back to a .ini file."""
        target = filename or self.original_filename
        if not target:
            raise IniError("saveFile() needs a filename (none stored from a previous read)")
        with open(target, "w", encoding="utf-8") as stream:
            stream.write(str(self))

    def relativeFileName(self, name, default=None):
        path = self.string(name, default)
        if os.path.isabs(path) or self.original_filename is None:
            return path
        return os.path.join(os.path.dirname(self.original_filename), path)

    # -- rendering ------------------------------------------------------------------------

    def fileLines(self):
        lines = [f"INCLUDE({inc})" for inc in self.includes]
        lines += [f"DEFAULT({d})" for d in self.defaults]
        emitted = set()
        ordered = [k for k in self.readOrder if k in self.params and not (k in emitted or emitted.add(k))]
        ordered += sorted(k for k in self.params if k not in emitted)
        lines += [f"{key}={_ini_text(self.params[key])}" for key in ordered]
        return lines

    def __str__(self):
        lines = self.fileLines()
        return "\n".join(lines)
