"""Hard prior bounds (host-side metadata).

The port's own copy of ``getdist_tpu/parampriors.py``: the
``.ranges``/``.bounds`` text format of the reference
(``getdist/parampriors.py``), one line per parameter, ``name lower upper
[periodic]`` where ``N`` means unbounded, read and written, and the
priors of a Cobaya ``.yaml`` info file.
Bounds feed the fused and parity paths as limits and periodic flags.
"""

import os

import numpy as np

__all__ = ["ParamBounds"]


class ParamBounds:
    """Lower/upper limits per parameter name; None/'N' = unbounded.

    :ivar names: parameter names in load order
    :ivar lower: dict name -> lower bound (absent if unbounded)
    :ivar upper: dict name -> upper bound (absent if unbounded)
    :ivar periodic: set of periodic parameter names
    """

    def __init__(self, fileName=None):
        self.names = []
        self.periodic = set()
        self.lower, self.upper = {}, {}
        if fileName is not None:
            self.loadFromFile(fileName)

    def _read_ranges_text(self, fileName):
        with open(fileName, encoding="utf-8-sig") as handle:
            for line in handle:
                fields = line.split()
                if len(fields) in (3, 4):
                    self.setRange(fields[0], fields[1:])

    def _read_cobaya_yaml(self, fileName):
        from getdist_tpu_torch import cobaya_interface as cobaya

        for p, info in cobaya.get_info_params(fileName).items():
            self.setRange(p, cobaya.get_range(info))

    def loadFromFile(self, fileName):
        """Load from ``.ranges``/``.bounds`` text or Cobaya ``.yaml``."""
        _, tail = os.path.split(fileName)
        self.filenameLoadedFrom = tail
        ext = os.path.splitext(fileName)[-1]
        readers = {
            ".ranges": self._read_ranges_text,
            ".bounds": self._read_ranges_text,
            ".yaml": self._read_cobaya_yaml,
            ".yml": self._read_cobaya_yaml,
        }
        reader = readers.get(ext)
        if reader is None:
            raise ValueError(f"ParamBounds must load from .bounds, .ranges or .yaml/.yml, not {fileName}")
        reader(fileName)

    @staticmethod
    def _bound_value(token, open_marker):
        """float bound, or None for an unbounded marker ('N'/None/+-inf)."""
        if token is None or token == "N" or token == open_marker:
            return None
        return float(token)

    def _mark_periodic(self, name, flag):
        verdict = flag
        if isinstance(flag, str):
            spelled = flag.upper()
            if spelled in ("T", "TRUE", "PERIODIC"):
                verdict = True
            elif spelled in ("F", "FALSE"):
                verdict = False
        if verdict is True:
            both = name in self.lower and name in self.upper
            if not both:
                raise ValueError(f"Periodic parameter must have lower and upper bound: {name}")
            self.periodic.add(name)
        elif verdict is not False:
            raise ValueError(f"Unknown value for periodic range settings for param {name}: {flag}")

    def setRange(self, name, strings):
        """Set bounds from a (lower, upper[, periodic]) tuple of strings or
        numbers; 'N'/None/inf mean unbounded."""
        if strings[0] is None and strings[1] is None:
            return
        self._require_name(name)
        low = self._bound_value(strings[0], -np.inf)
        if low is not None:
            self.lower[name] = low
        high = self._bound_value(strings[1], np.inf)
        if high is not None:
            self.upper[name] = high
        if len(strings) > 2:
            self._mark_periodic(name, strings[2])
        if name not in self.names:
            self.names += [name]

    def setFixed(self, name, value):
        self.setRange(name, (value, value))

    @staticmethod
    def _require_name(name):
        if not isinstance(name, str):
            raise ValueError(f"parameter name must be a string, got {type(name)}: {name}")

    def _bound_lookup(self, table, name):
        self._require_name(name)
        return table.get(name)

    def getLower(self, name):
        """Lower limit for name, or None."""
        return self._bound_lookup(self.lower, name)

    def getUpper(self, name):
        """Upper limit for name, or None."""
        return self._bound_lookup(self.upper, name)

    def fixedValue(self, name):
        """The fixed value if lower == upper, else None."""
        low = self.lower.get(name)
        if low is not None and self.upper.get(name) == low:
            return low
        return None

    def fixedValueDict(self):
        """Dict of all parameters pinned to a single value."""
        pinned = ((name, self.fixedValue(name)) for name in self.names)
        return {name: value for name, value in pinned if value is not None}

    def __str__(self):
        lines = []
        for name in self.names:
            low = self.lower.get(name)
            high = self.upper.get(name)
            lim1 = "%15.7E" % low if low is not None else "    N"
            lim2 = "%15.7E" % high if high is not None else "    N"
            if name in self.periodic:
                lines.append("%22s%17s%17s%10s" % (name, lim1, lim2, "periodic"))
            else:
                lines.append("%22s%17s%17s" % (name, lim1, lim2))
        return "\n".join(lines) + ("\n" if lines else "")

    def saveToFile(self, fileName):
        """Write the plain-text ranges format."""
        with open(fileName, "w", encoding="utf-8") as handle:
            handle.write(str(self))
