"""Key=value analysis settings files; the port's own copy of the parts of
``getdist_tpu/inifile.py`` that ``MCSamples`` reads its settings with.

Behavioral spec: reference ``getdist/inifile.py:10-412``: typed getters
(bool as T/F, space-separated lists and ndarrays) and ``setAttr``
reflection that writes typed values onto objects using the type of the
current attribute value. ``INCLUDE(file)`` / ``DEFAULT(file)`` inheritance,
``$(ENVVAR)`` expansion and saving are not ported yet (ROADMAP A10): a
file that uses a directive raises.
"""

import numpy as np

__all__ = ["IniFile", "IniError"]


class IniError(Exception):
    pass


class IniFile:
    """Stores option values read from a .ini file or a dict.

    :ivar params: dictionary of stored name -> value
    """

    def __init__(self, settings=None):
        """
        :param settings: filename of a .ini file to read, or a dict of values
        """
        self.params = {}
        if settings is not None:
            if isinstance(settings, str):
                self.readFile(settings)
            else:
                self.params.update(settings)

    # -- presence & typed getters ----------------------------------------------

    def hasKey(self, name):
        """True when the parameter name exists."""
        return name in self.params

    def isSet(self, name, allowEmpty=False):
        """True when the parameter exists and (unless allowEmpty) is non-empty."""
        if name not in self.params:
            return False
        return allowEmpty or self.params[name] != ""

    def asType(self, name, tp, default=None, allowEmpty=False):
        if not self.isSet(name, allowEmpty):
            if default is None:
                raise IniError(f"no such .ini parameter: {name}")
            return default
        # types with bespoke parsing go through their own getter
        bespoke = {bool: self.bool, list: self.split, np.ndarray: self.ndarray}
        handler = bespoke.get(tp)
        return handler(name, default) if handler else tp(self.params[name])

    def bool(self, name, default=False):
        """Boolean value (text starting T = True, F = False)."""
        if not self.isSet(name):
            if default is None:
                raise IniError(f"no such .ini parameter: {name}")
            return default
        text = self.params[name]
        if isinstance(text, bool):
            return text
        flag = {"T": True, "F": False}.get(text[:1])
        if flag is None:
            raise IniError(f".ini parameter {name} is not a valid T(rue)/F(alse) boolean")
        return flag

    def string(self, name, default=None, allowEmpty=True):
        """String value."""
        return self.asType(name, str, default, allowEmpty)

    def float(self, name, default=None):
        """Float value."""
        return self.asType(name, float, default)

    def int(self, name, default=None):
        """Int value."""
        return self.asType(name, int, default)

    def split(self, name, default=None, tp=None):
        """List of values from a space-separated entry, optionally cast to tp."""
        cast = (lambda seq: seq) if tp is None else (lambda seq: [tp(x) for x in seq])
        stored = self.params.get(name)
        if isinstance(stored, (list, tuple)):
            return cast(stored)
        text = self.string(name, default)
        return cast(text.split()) if isinstance(text, str) else text

    def ndarray(self, name, default=None, tp=np.float64):
        """Numpy array of values."""
        return np.array(self.split(name, default, tp=tp))

    def setAttr(self, name, instance, default=None, allowEmpty=False):
        """Set instance.name from the parameter, cast to the type of the
        attribute's current (or default) value."""
        current = getattr(instance, name, default)
        typed = self.asType(name, type(current), current, allowEmpty=allowEmpty)
        setattr(instance, name, typed)

    # -- file input ------------------------------------------------------------------

    def readFile(self, filename):
        """Read ``key = value`` lines (``#`` comments, ``END`` stops)."""
        with open(filename, encoding="utf-8-sig") as stream:
            for raw in stream:
                line = raw.strip()
                if line == "END":
                    break
                if not line or line.startswith("#"):
                    continue
                if line.startswith(("INCLUDE(", "DEFAULT(")) or "$(" in line:
                    raise NotImplementedError(
                        f"{filename}: INCLUDE/DEFAULT inheritance and $(VAR) expansion are not ported to "
                        "getdist_tpu_torch yet (ROADMAP A10)"
                    )
                if "=" not in line:
                    continue
                key, _, value = line.partition("=")
                key = key.strip()
                if key in self.params:
                    raise IniError(f"Error: duplicate key: {key} in {filename}")
                self.params[key] = value.strip()
        return self.params
