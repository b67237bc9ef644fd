"""Hard prior bounds (host-side metadata).

The port's own copy of the parts of ``getdist_tpu/parampriors.py`` that an
``MCSamples`` built from arrays uses: lower/upper bounds and the periodic
flag per parameter name, set from (lower, upper[, periodic]) values, where
``N``/None/inf mean unbounded (reference ``getdist/parampriors.py``).
Loading and saving ``.ranges``/``.bounds`` or Cobaya files is not ported
yet (ROADMAP A10).
"""

import numpy as np

__all__ = ["ParamBounds"]


class ParamBounds:
    """Lower/upper limits per parameter name; None/'N' = unbounded.

    :ivar names: parameter names in the order they were set
    :ivar lower: dict name -> lower bound (absent if unbounded)
    :ivar upper: dict name -> upper bound (absent if unbounded)
    :ivar periodic: set of periodic parameter names
    """

    def __init__(self):
        self.names = []
        self.periodic = set()
        self.lower, self.upper = {}, {}

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

    def getLower(self, name):
        """Lower limit for name, or None."""
        self._require_name(name)
        return self.lower.get(name)

    def getUpper(self, name):
        """Upper limit for name, or None."""
        self._require_name(name)
        return self.upper.get(name)
